"""int8 convolution of the quantized serving path (port of
``retinanet_tpu/models/layers.py:_int8_conv`` and of the TPU kernel
``retinanet_tpu/ops/pallas/int8_conv.py:int8_conv3x3``).

``int8_conv`` is what ``Conv(quantize=True)`` calls: symmetric dynamic
quantization with one activation scale over the whole tensor,
``s_x = max(max|x|, 1e-8) / 127``, per-output-channel weight scales
``s_w = max(max|w|, 1e-12) / 127``, ``x_q = clip(round(x / s_x))`` and
``w_q = clip(round(w / s_w))`` in [-127, 127], an exact s8×s8→s32 TF-SAME
convolution, and ``float(acc) · (s_x·s_w)`` cast to the output dtype.
Because s_x spans the batch, an image's result depends on the images that
share its batch, as in the JAX package.

For a CUDA tensor the wrapper launches kernel B6 (``csrc/int8_conv.cu``):
one pass that quantizes x to s8, then an implicit-GEMM convolution on the
int8 tensor cores with the dequantizing epilogue.  For a CPU tensor it
runs ``int8_conv_plain``, which convolves the quantized integers in
float64 (exact: every sum stays below 2⁵³) and applies the same fp32
epilogue, so the two agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import same_padding
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("int8_conv.cu", {
    "int8_quantize": [_P, _I, _P, _P, ctypes.c_size_t, _P],
    "int8_conv_fwd": [_P, _P, _P, _P, _P, _P] + [_I] * 14 + [_P],
})

# Input and output dtypes the kernels take, by the code the C side reads.
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def quantize_activations(x: Tensor) -> Tensor:
    """0-dim fp32 s_x = max(max|x|, 1e-8) / 127 over the whole tensor,
    left on x's device (no host synchronisation)."""
    lo, hi = torch.aminmax(x)
    amax = torch.maximum(-lo, hi).float()
    return torch.clamp(amax, min=1e-8) / 127.0


def quantize_weights(kernel: Tensor) -> Tuple[Tensor, Tensor]:
    """(w_q int8 OIHW, s_w fp32 [O]) of an fp32 OIHW kernel, one scale per
    output channel (amax over I, H, W)."""
    k = kernel.float()
    s_w = torch.clamp(k.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(k / s_w[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8), s_w


def _quantize_plain(x: Tensor, s_x: Tensor) -> Tensor:
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)


def int8_conv_plain(x: Tensor, kernel: Tensor, strides: int = 1,
                    out_dtype: torch.dtype = torch.bfloat16,
                    bias: Optional[Tensor] = None,
                    relu: bool = False) -> Tensor:
    """Plain PyTorch version.  x [B,H,W,C] (NHWC), kernel OIHW fp32;
    returns NHWC ``out_dtype``.  ``bias``/``relu`` follow ``int8_conv3x3``:
    added in fp32 after the dequantization, then relu, then the cast."""
    kh = kernel.shape[2]
    s_x = quantize_activations(x)
    w_q, s_w = quantize_weights(kernel)
    x_q = _quantize_plain(x, s_x).permute(0, 3, 1, 2).double()
    top, bottom = same_padding(x.shape[1], kh, strides)
    left, right = same_padding(x.shape[2], kh, strides)
    acc = F.conv2d(F.pad(x_q, (left, right, top, bottom)), w_q.double(),
                   stride=strides)
    y = acc.float() * (s_x * s_w)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    if relu:
        y = torch.clamp(y, min=0.0)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _int8_conv_cuda(x: Tensor, kernel: Tensor, strides: int,
                    out_dtype: torch.dtype, bias: Optional[Tensor],
                    relu: bool) -> Tensor:
    bsz, h, w, c = x.shape
    f, cin, kh, kw = kernel.shape
    if cin != c or kh != kw or kh not in (1, 3) or strides not in (1, 2):
        raise ValueError(f"B6 takes a 1x1 or 3x3 OIHW kernel with stride 1 "
                         f"or 2 over x's {c} channels, got kernel "
                         f"{tuple(kernel.shape)}, stride {strides}")
    if c % 64 or f % 64:
        raise ValueError(f"B6 needs C and F divisible by 64, got C={c}, "
                         f"F={f}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"B6 takes bf16 or fp32 in and out, got "
                         f"{x.dtype} -> {out_dtype}")
    if kernel.device != x.device or (bias is not None
                                     and bias.device != x.device):
        raise ValueError(f"kernel and bias must lie on {x.device}")
    if bias is not None and bias.numel() != f:
        raise ValueError(f"bias needs {f} elements, got {bias.numel()}")
    check_cuda(x, "x", x.dtype)
    s_x = quantize_activations(x)
    w_q, s_w = quantize_weights(kernel)
    w_q = w_q.permute(0, 2, 3, 1).reshape(f, kh * kw * c).contiguous()
    bias32 = bias.float().contiguous() if bias is not None else None
    top, _ = same_padding(h, kh, strides)
    left, _ = same_padding(w, kh, strides)
    ho, wo = -(-h // strides), -(-w // strides)
    x_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty(bsz, ho, wo, f, dtype=out_dtype, device=x.device)
    stream = stream_ptr(x.device)
    LIB.call("int8_quantize", x.data_ptr(), _DTYPE_CODES[x.dtype],
             s_x.data_ptr(), x_q.data_ptr(), x.numel(), stream)
    LIB.call("int8_conv_fwd", x_q.data_ptr(), w_q.data_ptr(),
             s_x.data_ptr(), s_w.data_ptr(),
             None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
             bsz, h, w, c, f, kh, strides, top, left, ho, wo,
             _DTYPE_CODES[out_dtype], int(bias is not None), int(relu), stream)
    int8_conv.launches += 1
    return out


def int8_conv(x: Tensor, kernel: Tensor, strides: int = 1,
              out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``_int8_conv`` of the JAX package: x [B,H,W,C] (NHWC, bf16 or fp32),
    kernel OIHW fp32 (as the port stores it), k ∈ {1, 3}, stride ∈ {1, 2},
    TF-SAME.  Returns NHWC in ``out_dtype`` (default x's).  On CUDA, C and
    F must be multiples of 64."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        return int8_conv_plain(x, kernel, strides, out_dtype)
    return _int8_conv_cuda(x, kernel, strides, out_dtype, None, False)


int8_conv.launches = 0


def int8_conv3x3(x: Tensor, w: Tensor, bias: Optional[Tensor] = None,
                 relu: bool = False) -> Tensor:
    """The JAX entry point's signature: 3×3 SAME stride-1 conv, x
    [B,H,W,C] (cast to bf16), w [3,3,C,F] fp32 (HWIO), optional bias [F];
    dequantize, add the bias in fp32, relu, and return bf16 NHWC.  The
    activation is quantized by division, as the model path does (the TPU
    kernel multiplies by 1/s_x)."""
    if w.shape[:2] != (3, 3):
        raise ValueError(f"int8_conv3x3 takes a [3,3,C,F] kernel, got "
                         f"{tuple(w.shape)}")
    x = x.to(torch.bfloat16)
    kernel = w.permute(3, 2, 0, 1)
    if not x.is_cuda:
        return int8_conv_plain(x, kernel, 1, torch.bfloat16, bias, relu)
    return _int8_conv_cuda(x, kernel, 1, torch.bfloat16, bias, relu)
