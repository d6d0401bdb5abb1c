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

A grouped conv (``groups`` > 1, kernel ``[F, C/g, k, k]``) is the same
function as its block-diagonal dense form: the zero weights add nothing to
the integer sums, and each output channel's amax, hence s_w, is the same.
B6 runs that dense form; the plain version convolves with ``groups``.

The weights are quantized once per parameter version: ``prepare_weights``
gives ``Int8Weights`` (w_q as the GEMM reads it: the dense kernel laid out
``[Fp, k·k·Cp]`` tap-major, C and F zero-padded to multiples of
``PAD``, and s_w), which ``Conv(quantize=True)`` keeps and rebuilds when
its kernel changes; ``int8_conv(..., weights=None)`` quantizes them per
call.  For a CUDA tensor the wrapper then launches kernel B6
(``csrc/int8_conv.cu``) three times: ``int8_amax`` (s_x on the device),
the quantize pass (which writes x_q with its channels zero-padded to Cp),
and the implicit-GEMM convolution on the int8 tensor cores with the
dequantizing epilogue, which stores the first F of its Fp columns.  C and
F may be any multiple of 8.  For a CPU tensor it runs the plain
version, which convolves the quantized integers in float64 (exact: every
sum stays below 2⁵³) and applies the same fp32 epilogue, so the two agree
bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import same_padding
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda
from retinanet_tpu_torch.ops.grouped import block_diagonal

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("int8_conv.cu", {
    "int8_conv_forward": [_P] * 8 + [_I] * 4 + [_P],
})

# Input and output dtypes the kernels take, by the code the C side reads.
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# Scratch of the wrapper, one pair per device and stream (launches on one
# stream run in order, so they never share it): int8_amax's AMAX_MAX_CTAS
# per-CTA maxima, the ticket word (zero between launches) and s_x; and an
# x_q buffer of _XQ_BYTES, which spares the host an allocation for every x
# that fits (at batch 8, all of the flagship's).  A larger x_q, whose
# conv takes far longer on the card than its allocation on the host, is
# allocated per call, so the buffer never holds more than _XQ_BYTES.
_AMAX_CTAS = 1024
_XQ_BYTES = 64 << 20
# x_q's channels and w_q's rows and reduction are zero-padded to multiples
# of PAD: the GEMM's stage reads 64-byte halves of a row that must lie in
# one tap, and its N tiles are multiples of 64.  The padding of C
# multiplies x_q's bytes by Cp / C (4 at C = 16).
PAD = 64
_SCRATCH: Dict[Tuple[int, int], Tuple[Tensor, Tensor]] = {}
# int8_conv_forward's launches, as bits of its ``which``.
AMAX, QUANTIZE, GEMM = 1, 2, 4


def padded(n: int) -> int:
    """``n`` rounded up to a multiple of ``PAD``."""
    return -(-n // PAD) * PAD


class Int8Weights(NamedTuple):
    """A kernel quantized for B6: ``w_q`` int8 ``[Fp, kh·kw·Cp]``, the
    dense (block-diagonal where grouped) kernel with k tap-major (dy, dx,
    c) and zeros past F rows and C channels; ``s_w`` fp32 ``[F]``; the
    OIHW ``shape`` of the kernel they came from and its ``groups``."""
    w_q: Tensor
    s_w: Tensor
    shape: Tuple[int, int, int, int]
    groups: int = 1

    def dense_oihw(self) -> Tensor:
        """w_q as the dense int8 OIHW kernel ``[F, C, kh, kw]``."""
        f, cg, kh, kw = self.shape
        c = cg * self.groups
        return (self.w_q.view(-1, kh, kw, padded(c))[:f, :, :, :c]
                .permute(0, 3, 1, 2))


def quantize_activations(x: Tensor) -> Tensor:
    """0-dim fp32 s_x = max(max|x|, 1e-8) / 127 over the whole tensor,
    left on x's device (no host synchronisation).  The divisor is a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's rounded reciprocal, which is not always the quotient."""
    lo, hi = torch.aminmax(x)
    amax = torch.maximum(-lo, hi).float()
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)


def quantize_weights(kernel: Tensor) -> Tuple[Tensor, Tensor]:
    """(w_q int8 OIHW, s_w fp32 [O]) of an fp32 OIHW kernel, one scale per
    output channel (amax over I, H, W).  The divisor is a tensor, as in
    ``quantize_activations``: s_w is the correctly rounded quotient."""
    k = kernel.float()
    amax = torch.clamp(k.abs().amax(dim=(1, 2, 3)), min=1e-12)
    s_w = amax / torch.full_like(amax, 127.0)
    w_q = torch.clamp(torch.round(k / s_w[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8), s_w


def prepare_weights(kernel: Tensor, groups: int = 1) -> Int8Weights:
    """``quantize_weights`` of an OIHW kernel (grouped ``[F, C/g, kh, kw]``
    for ``groups`` g), laid out as B6's GEMM reads it: block-diagonal
    dense, padded with zeros (bitwise the same integers and scales)."""
    w_q, s_w = quantize_weights(kernel)
    if groups > 1:
        w_q = block_diagonal(w_q, groups)
    f, c, kh, kw = w_q.shape
    layout = torch.zeros(padded(f), kh, kw, padded(c), dtype=torch.int8,
                         device=kernel.device)
    layout[:f, :, :, :c] = w_q.permute(0, 2, 3, 1)
    prepare_weights.builds += 1
    return Int8Weights(layout.view(padded(f), kh * kw * padded(c)), s_w,
                       tuple(kernel.shape), groups)


prepare_weights.builds = 0


def _quantize_plain(x: Tensor, s_x: Tensor) -> Tensor:
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)


def _conv_quantized_plain(x: Tensor, w_q: Tensor, s_w: Tensor, strides: int,
                          out_dtype: torch.dtype, bias: Optional[Tensor],
                          relu: bool, groups: int = 1) -> Tensor:
    """The plain convolution of quantized OIHW weights (``groups`` of
    them): x quantized by ``quantize_activations``, integer sums in
    float64, fp32 epilogue."""
    kh = w_q.shape[2]
    s_x = quantize_activations(x)
    x_q = _quantize_plain(x, s_x).permute(0, 3, 1, 2).double()
    top, bottom = same_padding(x.shape[1], kh, strides)
    left, right = same_padding(x.shape[2], kh, strides)
    acc = F.conv2d(F.pad(x_q, (left, right, top, bottom)), w_q.double(),
                   stride=strides, groups=groups)
    y = acc.float() * (s_x * s_w)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    if relu:
        y = torch.clamp(y, min=0.0)
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def int8_conv_plain(x: Tensor, kernel: Tensor, strides: int = 1,
                    out_dtype: torch.dtype = torch.bfloat16,
                    bias: Optional[Tensor] = None,
                    relu: bool = False, groups: int = 1) -> Tensor:
    """Plain PyTorch version.  x [B,H,W,C] (NHWC), kernel OIHW fp32
    (``[F, C/g, k, k]`` for ``groups`` g); returns NHWC ``out_dtype``.
    ``bias``/``relu`` follow ``int8_conv3x3``: added in fp32 after the
    dequantization, then relu, then the cast."""
    w_q, s_w = quantize_weights(kernel)
    return _conv_quantized_plain(x, w_q, s_w, strides, out_dtype, bias, relu,
                                 groups)


def tile_n(f: int, m: int, k: int) -> int:
    """B6's output-channel tile for F channels, M output pixels and K
    bytes of reduction: the widest of 256, 128, 64 that divides F and
    leaves the grid at least half a CTA per SM (66), 256 only where K
    exceeds two 128-byte stages (a short K gains nothing from the wider
    tile and loses occupancy); else 64."""
    tiles = -(-m // 128)
    for n in (256, 128):
        if f % n == 0 and (n < 256 or k > 256) and tiles * (f // n) >= 66:
            return n
    return 64


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, by the raw query
    PyTorch's generated code uses (a few microseconds less per call than
    ``torch.cuda.current_stream``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def scratch(device: torch.device, stream: Optional[int] = None,
            x_bytes: int = 0) -> Tuple[Tensor, Tensor]:
    """(``int8_amax``'s scratch, an int8 x_q buffer of at least
    ``x_bytes``) of this device and stream (default: the current one); s_x
    is the first one's last word, as fp32.  The x_q buffer is the shared
    one up to ``_XQ_BYTES``, else a new one."""
    key = (device.index, current_stream(device) if stream is None
           else stream)
    pair = _SCRATCH.get(key)
    if pair is None:
        pair = _SCRATCH[key] = (
            torch.zeros(_AMAX_CTAS + 2, dtype=torch.int32, device=device),
            torch.empty(_XQ_BYTES, dtype=torch.int8, device=device))
    if x_bytes <= _XQ_BYTES:
        return pair
    return pair[0], torch.empty(x_bytes, dtype=torch.int8, device=device)


@functools.lru_cache(maxsize=None)
def _geometry(x_shape: Tuple[int, ...], x_dtype: torch.dtype,
              k_shape: Tuple[int, ...], strides: int,
              out_dtype: torch.dtype, groups: int = 1):
    """Checks one conv's shapes and dtypes, once per geometry, and returns
    (the address of ``int8_conv_forward``'s ``geom`` array: in_code, B, H,
    W, C, F, k, stride, pad_t, pad_l, Ho, Wo, out_code; the array; the
    ``tile_n`` tile; the output's shape).  The cache keeps the array
    alive."""
    bsz, h, w, c = x_shape
    f, cin, kh, kw = k_shape
    if (cin * groups != c or f % groups or kh != kw or kh not in (1, 3)
            or strides not in (1, 2)):
        raise ValueError(f"B6 takes a 1x1 or 3x3 OIHW kernel with stride 1 "
                         f"or 2 over x's {c} channels in {groups} groups, "
                         f"got kernel {tuple(k_shape)}, stride {strides}")
    if c % 8 or f % 8:
        raise ValueError(f"B6 needs C and F divisible by 8, got C={c}, "
                         f"F={f}")
    if x_dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"B6 takes bf16 or fp32 in and out, got "
                         f"{x_dtype} -> {out_dtype}")
    ho, wo = -(-h // strides), -(-w // strides)
    top, _ = same_padding(h, kh, strides)
    left, _ = same_padding(w, kh, strides)
    geom = (ctypes.c_int * 13)(_DTYPE_CODES[x_dtype], bsz, h, w, c, f, kh,
                               strides, top, left, ho, wo,
                               _DTYPE_CODES[out_dtype])
    return (ctypes.addressof(geom), geom,
            tile_n(padded(f), bsz * ho * wo, kh * kh * padded(c)),
            (bsz, ho, wo, f))


def xq_bytes(x_shape: Tuple[int, ...]) -> int:
    """Bytes of B6's x_q for an NHWC x: its channels padded to Cp."""
    b, h, w, c = x_shape
    return b * h * w * padded(c)


def launch(x: Tensor, x_q: Tensor, work: Tensor, weights: Int8Weights,
           out: Tensor, strides: int, bias: Optional[Tensor] = None,
           relu: bool = False, which: int = AMAX | QUANTIZE | GEMM,
           stream: Optional[int] = None) -> None:
    """B6's launches on x [B,H,W,C] into out [B,Ho,Wo,F] (bf16 or fp32),
    with x_q (int8, at least ``xq_bytes``) and ``work`` (``scratch``) as
    scratch; ``bias`` contiguous fp32 or None.  ``which`` picks the
    launches (the GEMM alone reads the x_q and s_x a previous call left),
    ``stream`` the CUDA stream (default: the current one)."""
    geom, _, tile, _ = _geometry(x.shape, x.dtype, weights.shape, strides,
                                 out.dtype, weights.groups)
    LIB.call("int8_conv_forward", x.data_ptr(), x_q.data_ptr(),
             work.data_ptr(), weights.w_q.data_ptr(), weights.s_w.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             geom, int(bias is not None), int(relu), tile, which,
             stream or current_stream(x.device))


def _int8_conv_cuda(x: Tensor, kernel: Tensor, strides: int,
                    out_dtype: torch.dtype, bias: Optional[Tensor],
                    relu: bool, weights: Optional[Int8Weights] = None,
                    groups: int = 1) -> Tensor:
    out_shape = _geometry(x.shape, x.dtype, kernel.shape, strides,
                          out_dtype, groups)[3]
    if kernel.device != x.device or (bias is not None
                                     and bias.device != x.device):
        raise ValueError(f"kernel and bias must lie on {x.device}")
    if bias is not None and bias.numel() != out_shape[3]:
        raise ValueError(f"bias needs {out_shape[3]} elements, got "
                         f"{bias.numel()}")
    check_cuda(x, "x", x.dtype)
    if weights is None:
        weights = prepare_weights(kernel, groups)
    if weights.shape != kernel.shape or weights.groups != groups:
        raise ValueError(f"prepared weights of shape {weights.shape} in "
                         f"{weights.groups} groups do not fit kernel "
                         f"{tuple(kernel.shape)} in {groups}")
    check_cuda(weights.w_q, "w_q", torch.int8)
    bias32 = bias.float().contiguous() if bias is not None else None
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    stream = current_stream(x.device)
    work, x_q = scratch(x.device, stream, xq_bytes(x.shape))
    launch(x, x_q, work, weights, out, strides, bias32, relu, stream=stream)
    int8_conv.launches += 1
    return out


def int8_conv(x: Tensor, kernel: Tensor, strides: int = 1,
              out_dtype: Optional[torch.dtype] = None,
              weights: Optional[Int8Weights] = None,
              groups: int = 1) -> Tensor:
    """``_int8_conv`` of the JAX package: x [B,H,W,C] (NHWC, bf16 or fp32),
    kernel OIHW fp32 (as the port stores it; ``[F, C/g, k, k]`` for
    ``groups`` g), k ∈ {1, 3}, stride ∈ {1, 2}, TF-SAME.  Returns NHWC in
    ``out_dtype`` (default x's).  ``weights``: the kernel's
    ``prepare_weights``, kept by the caller; without it the kernel is
    quantized here.  On CUDA, C and F must be multiples of 8."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        if weights is None:
            return int8_conv_plain(x, kernel, strides, out_dtype,
                                   groups=groups)
        return _conv_quantized_plain(x, weights.dense_oihw(), weights.s_w,
                                     strides, out_dtype, None, False)
    return _int8_conv_cuda(x, kernel, strides, out_dtype, None, False,
                           weights, groups)


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
