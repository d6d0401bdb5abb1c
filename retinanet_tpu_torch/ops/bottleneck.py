"""Fused stride-1 bottlenecks (port of
``retinanet_tpu/ops/pallas/bottleneck.py:fused_bottleneck`` and
``fused_bottleneck_proj``).

``fused_bottleneck`` (B1) launches the hand-written CUDA kernel
(``csrc/bottleneck.cu``) for a CUDA tensor and runs
``fused_bottleneck_plain`` for a CPU tensor; there is no fallback from one
to the other.  Both compute

    relu(GN3(conv1x1(relu(GN2(conv3x3(relu(GN1(conv1x1(x))))))) + x)

with every conv rounded once to bf16, GN statistics in fp32 from the
rounded values, and the bf16 affine of ``models/layers.py:group_norm``.
``fused_bottleneck_proj`` (B5, ``csrc/bottleneck_proj.cu``) is the same
block with the projection ``GNp(x·kp)`` in place of the identity (res2 b0),
with the same rounding points: yp rounds to bf16 and its affine runs in
bf16 before the bf16 residual add.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import group_norm, resolve_groups
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("bottleneck.cu", {
    "fused_bottleneck_fwd": [_P] * 16 + [_I] * 7 + [ctypes.c_float, _P],
})
PROJ_LIB = KernelLibrary("bottleneck_proj.cu", {
    "fused_bottleneck_proj_fwd": [_P] * 20 + [_I] * 8 + [ctypes.c_float, _P],
})


def _conv_gn(xc: Tensor, k: Tensor, gamma: Tensor, beta: Tensor, eps: float,
             activation=None, padding: int = 0) -> Tensor:
    """The unfused ConvGN: bf16-rounded conv, then ``group_norm``."""
    w = k.to(dtype=xc.dtype, memory_format=torch.channels_last)
    return group_norm(F.conv2d(xc, w, padding=padding), gamma, beta,
                      resolve_groups(k.shape[0]), eps, activation)


def _residual_branch(xc: Tensor, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                     eps: float) -> Tensor:
    """GN3(conv3(relu(GN2(conv2(relu(GN1(conv1(x)))))))) of an NCHW view."""
    y = _conv_gn(xc, k1, g1, b1, eps, "relu")
    y = _conv_gn(y, k2, g2, b2, eps, "relu", padding=1)
    return _conv_gn(y, k3, g3, b3, eps)


def fused_bottleneck_plain(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                           k2: Tensor, g2: Tensor, b2: Tensor,
                           k3: Tensor, g3: Tensor, b3: Tensor,
                           eps: float = 1e-5) -> Tensor:
    """Plain PyTorch version: the unfused block's convs and GroupNorms."""
    xc = x.permute(0, 3, 1, 2)
    y = _residual_branch(xc, k1, g1, b1, k2, g2, b2, k3, g3, b3, eps)
    return F.relu(y + xc).permute(0, 2, 3, 1).contiguous()


def fused_bottleneck(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                     k2: Tensor, g2: Tensor, b2: Tensor,
                     k3: Tensor, g3: Tensor, b3: Tensor,
                     eps: float = 1e-5) -> Tensor:
    """One identity bottleneck block.

    x [B,H,W,C] bf16 (NHWC); kernels OIHW as the port stores them:
    k1 [F,C,1,1], k2 [F,F,3,3], k3 [C,F,1,1]; g*/b* the GN affines (fp32).
    Returns bf16 [B,H,W,C].  On CUDA, C and F must be multiples of 64.
    """
    if not x.is_cuda:
        return fused_bottleneck_plain(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                      eps)
    bsz, h, w, c = x.shape
    f = k1.shape[0]
    if (k1.shape != (f, c, 1, 1) or k2.shape != (f, f, 3, 3)
            or k3.shape != (c, f, 1, 1)):
        raise ValueError(f"kernel shapes {tuple(k1.shape)}, "
                         f"{tuple(k2.shape)}, {tuple(k3.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if c % 64 or f % 64:
        raise ValueError(f"the CUDA bottleneck needs C and F divisible by "
                         f"64, got C={c}, F={f}")
    affines = (g1, b1, g2, b2, g3, b3)
    if [t.numel() for t in affines] != [f] * 4 + [c] * 2:
        raise ValueError(f"GN affines need F={f} (GN1, GN2) and C={c} (GN3) "
                         f"elements, got {[t.numel() for t in affines]}")
    if any(t.device != x.device for t in (k1, k2, k3, *affines)):
        raise ValueError(f"kernels and GN affines must lie on {x.device}")
    check_cuda(x, "x", torch.bfloat16)
    bf = torch.bfloat16
    w1 = k1.reshape(f, c).to(bf).contiguous()
    w2 = k2.to(bf).permute(0, 2, 3, 1).reshape(f, 9 * f).contiguous()
    w3 = k3.reshape(c, f).to(bf).contiguous()
    gb = [t.float().contiguous() for t in (g1, b1, g2, b2, g3, b3)]
    hw = h * w
    mt = -(-hw // 64)
    y1 = torch.empty(bsz, hw, f, dtype=bf, device=x.device)
    y2 = torch.empty_like(y1)
    y3 = torch.empty(bsz, hw, c, dtype=bf, device=x.device)
    part = torch.empty(bsz, mt, 2, c, dtype=torch.float32, device=x.device)
    ss = torch.empty(6, bsz, c, dtype=bf, device=x.device)
    out = torch.empty_like(x)
    LIB.call("fused_bottleneck_fwd",
             x.data_ptr(), w1.data_ptr(), gb[0].data_ptr(), gb[1].data_ptr(),
             w2.data_ptr(), gb[2].data_ptr(), gb[3].data_ptr(),
             w3.data_ptr(), gb[4].data_ptr(), gb[5].data_ptr(),
             y1.data_ptr(), y2.data_ptr(), y3.data_ptr(), part.data_ptr(),
             ss.data_ptr(), out.data_ptr(),
             bsz, h, w, c, f, resolve_groups(f), resolve_groups(c),
             float(eps), stream_ptr(x.device))
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_bottleneck_proj_plain(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                                k2: Tensor, g2: Tensor, b2: Tensor,
                                k3: Tensor, g3: Tensor, b3: Tensor,
                                kp: Tensor, gp: Tensor, bp: Tensor,
                                eps: float = 1e-5) -> Tensor:
    """Plain PyTorch version: the unfused projection block's ops."""
    xc = x.permute(0, 3, 1, 2)
    y = _residual_branch(xc, k1, g1, b1, k2, g2, b2, k3, g3, b3, eps)
    idn = _conv_gn(xc, kp, gp, bp, eps)
    return F.relu(y + idn).permute(0, 2, 3, 1).contiguous()


def fused_bottleneck_proj(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                          k2: Tensor, g2: Tensor, b2: Tensor,
                          k3: Tensor, g3: Tensor, b3: Tensor,
                          kp: Tensor, gp: Tensor, bp: Tensor,
                          eps: float = 1e-5) -> Tensor:
    """One stride-1 projection block: relu(GN3(conv3(a2)) + GNp(x·kp)).

    x [B,H,W,Cin] bf16 (NHWC); kernels OIHW: k1 [F,Cin,1,1], k2 [F,F,3,3],
    k3 [C,F,1,1], kp [C,Cin,1,1]; g*/b* fp32.  Returns bf16 [B,H,W,C].  On
    CUDA, Cin, F and C must be multiples of 64.
    """
    if not x.is_cuda:
        return fused_bottleneck_proj_plain(x, k1, g1, b1, k2, g2, b2, k3, g3,
                                           b3, kp, gp, bp, eps)
    bsz, h, w, cin = x.shape
    f, c = k1.shape[0], k3.shape[0]
    if (k1.shape != (f, cin, 1, 1) or k2.shape != (f, f, 3, 3)
            or k3.shape != (c, f, 1, 1) or kp.shape != (c, cin, 1, 1)):
        raise ValueError(f"kernel shapes {tuple(k1.shape)}, "
                         f"{tuple(k2.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(kp.shape)} do not fit x {tuple(x.shape)}")
    if cin % 64 or f % 64 or c % 64:
        raise ValueError(f"the CUDA projection block needs Cin, F and C "
                         f"divisible by 64, got {cin}, {f}, {c}")
    affines = (g1, b1, g2, b2, g3, b3, gp, bp)
    if [t.numel() for t in affines] != [f] * 4 + [c] * 4:
        raise ValueError(f"GN affines need F={f} (GN1, GN2) and C={c} "
                         f"(GN3, GNp) elements, got "
                         f"{[t.numel() for t in affines]}")
    if any(t.device != x.device for t in (k1, k2, k3, kp, *affines)):
        raise ValueError(f"kernels and GN affines must lie on {x.device}")
    check_cuda(x, "x", torch.bfloat16)
    bf = torch.bfloat16
    w1 = k1.reshape(f, cin).to(bf).contiguous()
    w2 = k2.to(bf).permute(0, 2, 3, 1).reshape(f, 9 * f).contiguous()
    w3 = k3.reshape(c, f).to(bf).contiguous()
    wp = kp.reshape(c, cin).to(bf).contiguous()
    gb = [t.float().contiguous() for t in affines]
    hw = h * w
    mt = -(-hw // 64)
    y1 = torch.empty(bsz, hw, f, dtype=bf, device=x.device)
    y2 = torch.empty_like(y1)
    y3 = torch.empty(bsz, hw, c, dtype=bf, device=x.device)
    yp = torch.empty_like(y3)
    part = torch.empty(bsz, mt, 2, c, dtype=torch.float32, device=x.device)
    ss = torch.empty(8, bsz, c, dtype=bf, device=x.device)
    out = torch.empty(bsz, h, w, c, dtype=bf, device=x.device)
    PROJ_LIB.call(
        "fused_bottleneck_proj_fwd",
        x.data_ptr(), w1.data_ptr(), gb[0].data_ptr(), gb[1].data_ptr(),
        w2.data_ptr(), gb[2].data_ptr(), gb[3].data_ptr(),
        w3.data_ptr(), gb[4].data_ptr(), gb[5].data_ptr(),
        wp.data_ptr(), gb[6].data_ptr(), gb[7].data_ptr(),
        y1.data_ptr(), y2.data_ptr(), y3.data_ptr(), yp.data_ptr(),
        part.data_ptr(), ss.data_ptr(), out.data_ptr(),
        bsz, h, w, cin, c, f, resolve_groups(f), resolve_groups(c),
        float(eps), stream_ptr(x.device))
    fused_bottleneck_proj.launches += 1
    return out


fused_bottleneck_proj.launches = 0
