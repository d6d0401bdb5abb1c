"""Fused stem epilogue (port of ``retinanet_tpu/ops/pallas/stem.py``):
kernel B7, GroupNorm affine + relu + 3×3/2 SAME max pool in one pass.

``gn_relu_maxpool`` takes the stem's conv output y [B,H,W,C] (NHWC, bf16)
and per-image [B,C] scale/shift, rounds both to bf16, applies the bf16
affine (the multiply rounds, the add rounds), relu, and the TF-SAME
3×3/2 max pool: one read of y, one write of the pooled output.  It
launches the CUDA kernel (``csrc/stem.cu``: a CTA per band of 4 output
rows and tile of output columns, walking down the band one input
row pair at a time) for a CUDA tensor and runs ``gn_relu_maxpool_plain``
for a CPU tensor; the two agree bitwise (no sums).

``fused_stem`` is the whole stem: the 7×7/2 TF-SAME conv (``stem_conv``,
PyTorch's convolution, as the JAX package leaves it to XLA), the fp32
GroupNorm statistics of ``models/layers.group_norm`` (``stem_statistics``),
then B7.  It equals the model's
``ConvGN(relu)`` + ``max_pool_same`` bitwise.  Neither is on a model path:
they are function entry points, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import (gn_scale_shift, max_pool_same,
                                               resolve_groups, same_padding)
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("stem.cu", {
    "gn_relu_maxpool_fwd": [_P] * 4 + [_I] * 8 + [_P],
})


def gn_relu_maxpool_plain(y: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    """Plain PyTorch version: bf16 relu(y·scale+shift), then
    ``max_pool_same``; y [B,H,W,C] → [B,⌈H/2⌉,⌈W/2⌉,C] bf16."""
    bf = torch.bfloat16
    yc = y.to(bf).permute(0, 3, 1, 2)
    z = F.relu(yc * scale.to(bf)[:, :, None, None]
               + shift.to(bf)[:, :, None, None])
    return max_pool_same(z, 3, 2).permute(0, 2, 3, 1).contiguous()


def gn_relu_maxpool(y: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    """relu(y·scale+shift) + 3×3/2 SAME max pool with per-image [B, C]
    scale/shift.  y [B,H,W,C] is cast to bf16; returns bf16
    [B, ⌈H/2⌉, ⌈W/2⌉, C].  On CUDA, C must be a multiple of 8 and an
    image under 2³¹ elements."""
    y = y.to(torch.bfloat16)
    if not y.is_cuda:
        return gn_relu_maxpool_plain(y, scale, shift)
    b, h, w, c = y.shape
    if c % 8:
        raise ValueError(f"B7 needs C divisible by 8, got C={c}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"B7 takes images under 2^31 elements, got "
                         f"{h}x{w}x{c}")
    if scale.shape != (b, c) or shift.shape != (b, c):
        raise ValueError(f"scale/shift need shape {(b, c)}, got "
                         f"{tuple(scale.shape)}, {tuple(shift.shape)}")
    if scale.device != y.device or shift.device != y.device:
        raise ValueError(f"scale and shift must lie on {y.device}")
    check_cuda(y, "y", torch.bfloat16)
    sc = scale.to(torch.bfloat16).contiguous()
    sh = shift.to(torch.bfloat16).contiguous()
    top, _ = same_padding(h, 3, 2)
    left, _ = same_padding(w, 3, 2)
    ho, wo = -(-h // 2), -(-w // 2)
    out = torch.empty(b, ho, wo, c, dtype=torch.bfloat16, device=y.device)
    LIB.call("gn_relu_maxpool_fwd", y.data_ptr(), sc.data_ptr(),
             sh.data_ptr(), out.data_ptr(), b, h, w, c, ho, wo, top, left,
             stream_ptr(y.device))
    gn_relu_maxpool.launches += 1
    return out


gn_relu_maxpool.launches = 0


def stem_conv(x: Tensor, w: Tensor) -> Tensor:
    """The 7×7/2 TF-SAME stem conv in bf16: x [B,H,W,3] (NHWC), w
    [7,7,3,C] (HWIO) → y [B,C,⌈H/2⌉,⌈W/2⌉] in channels_last memory."""
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    k = w.permute(3, 2, 0, 1).to(dtype=torch.bfloat16,
                                 memory_format=torch.channels_last)
    top, bottom = same_padding(xc.shape[2], k.shape[2], 2)
    left, right = same_padding(xc.shape[3], k.shape[3], 2)
    return F.conv2d(F.pad(xc, (left, right, top, bottom)), k, stride=2)


def stem_statistics(y: Tensor, gamma: Tensor, beta: Tensor,
                    eps: float = 1e-5):
    """Per-image fp32 GN (scale, shift) [B,C] of the stem conv's output y
    [B,C,H,W]: the fp32 sums of ``models/layers.group_norm``."""
    n, c, h, w = y.shape
    y32 = y.float()
    return gn_scale_shift(y32.sum(dim=(2, 3)), (y32 * y32).sum(dim=(2, 3)),
                          h * w, gamma, beta, resolve_groups(c), eps)


def fused_stem(x: Tensor, w: Tensor, gamma: Tensor, beta: Tensor,
               eps: float = 1e-5) -> Tensor:
    """The JAX entry point's signature: x [B,H,W,3] (NHWC), w [7,7,3,C]
    fp32 (HWIO), γ/β [C].  ``stem_conv``, ``stem_statistics``, then
    ``gn_relu_maxpool``.  Returns bf16 [B, ⌈H/4⌉, ⌈W/4⌉, C]."""
    y = stem_conv(x, w)
    scale, shift = stem_statistics(y, gamma, beta, eps)
    return gn_relu_maxpool(y.permute(0, 2, 3, 1).contiguous(), scale, shift)
