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

The kernels read bf16 layouts of the OIHW kernels (``prepare_weights``,
``prepare_proj_weights``; B5's conv1 and projection as one stacked
``[w1; wp]``).  ``models/resnet.py:ResNetBottleneck`` keeps them per
parameter version (``ops/cuda.py:ParameterCache``) and passes them as
``weights``; without it a call lays them out itself.  Each GEMM's last CTA
per image finalizes its GroupNorm through a ticket word per image, kept
zero between launches in one buffer per device and stream
(``ops/cuda.py:tickets``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import group_norm, resolve_groups
from retinanet_tpu_torch.ops.cuda import (KernelLibrary, check_cuda,
                                          stream_ptr, tickets)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("bottleneck.cu", {
    "fused_bottleneck_fwd": [_P] * 18 + [_I] * 7 + [ctypes.c_float, _P],
})
PROJ_LIB = KernelLibrary("bottleneck_proj.cu", {
    "fused_bottleneck_proj_fwd": [_P] * 20 + [_I] * 8 + [ctypes.c_float, _P],
})
# A prologue GN stages at most MAX_F channels (F) in shared memory.
MAX_F = 512
# A GEMM's output rows per CTA: its partial statistics are [B, MT, 2, N]
# with MT = ceil(H*W / TILE_ROWS).
TILE_ROWS = 128

# (y1, y2, y3, ((mean1, inv1), (mean2, inv2), (mean3, inv3))): a block's
# conv outputs [B, HW, ·] and each GN's statistics [B, ·].
Forward = Tuple[Tensor, Tensor, Tensor, Tuple[Tuple[Tensor, Tensor], ...]]


class BlockWeights(NamedTuple):
    """B1's bf16 weights: w1 [F,C], w2 [F,9F] (out, tap, in), w3 [C,F]."""
    w1: Tensor
    w2: Tensor
    w3: Tensor


class ProjWeights(NamedTuple):
    """B5's bf16 weights: w1p [F+C,Cin] the stacked conv1 and projection
    ``[w1; wp]``, w2 [F,9F] (out, tap, in), w3 [C,F]."""
    w1p: Tensor
    w2: Tensor
    w3: Tensor


def _taps(k2: Tensor) -> Tensor:
    f = k2.shape[0]
    return (k2.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(f, 9 * f)
            .contiguous())


def prepare_weights(k1: Tensor, k2: Tensor, k3: Tensor) -> BlockWeights:
    """B1's bf16 layouts of the OIHW kernels k1 [F,C,1,1], k2 [F,F,3,3],
    k3 [C,F,1,1]."""
    f, c = k1.shape[:2]
    prepare_weights.builds += 1
    return BlockWeights(k1.reshape(f, c).to(torch.bfloat16).contiguous(),
                        _taps(k2),
                        k3.reshape(c, f).to(torch.bfloat16).contiguous())


prepare_weights.builds = 0


def prepare_proj_weights(k1: Tensor, k2: Tensor, k3: Tensor,
                         kp: Tensor) -> ProjWeights:
    """B5's bf16 layouts of the OIHW kernels k1 [F,Cin,1,1], k2 [F,F,3,3],
    k3 [C,F,1,1] and kp [C,Cin,1,1]."""
    f, cin = k1.shape[:2]
    c = k3.shape[0]
    prepare_proj_weights.builds += 1
    stacked = torch.cat([k1.reshape(f, cin), kp.reshape(c, cin)])
    return ProjWeights(stacked.to(torch.bfloat16).contiguous(), _taps(k2),
                       k3.reshape(c, f).to(torch.bfloat16).contiguous())


prepare_proj_weights.builds = 0


def forward_of(y1: Tensor, y2: Tensor, y3: Tensor, mv: Tensor
               ) -> Forward:
    """A ``Forward`` from the kernels' planes and their ``mv`` [6, B, C]
    fp32, which holds mean1, inv1, mean2, inv2, mean3, inv3, each
    [B, F or C] packed at the start of its [B*C] row."""
    bsz, _, f = y1.shape
    c = y3.shape[2]
    rows = mv.view(6, bsz * c)
    stats = tuple(tuple(rows[2 * i + j, :bsz * n].view(bsz, n)
                        for j in (0, 1)) for i, n in enumerate((f, f, c)))
    return y1, y2, y3, stats


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


def _check_layout(weights, shapes, device) -> None:
    """Raise unless ``weights`` holds contiguous bf16 tensors of
    ``shapes`` on ``device``."""
    if any(tuple(w.shape) != s or w.dtype != torch.bfloat16
           or w.device != device or not w.is_contiguous()
           for w, s in zip(weights, shapes)):
        raise ValueError(f"weights {[tuple(w.shape) for w in weights]} are "
                         f"not bf16 {shapes} on {device}")


def fused_bottleneck(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                     k2: Tensor, g2: Tensor, b2: Tensor,
                     k3: Tensor, g3: Tensor, b3: Tensor,
                     eps: float = 1e-5,
                     weights: Optional[BlockWeights] = None,
                     return_forward: bool = False
                     ) -> Union[Tensor, Tuple[Tensor, Forward]]:
    """One identity bottleneck block.

    x [B,H,W,C] bf16 (NHWC); kernels OIHW as the port stores them:
    k1 [F,C,1,1], k2 [F,F,3,3], k3 [C,F,1,1]; g*/b* the GN affines (fp32).
    ``weights``: ``prepare_weights(k1, k2, k3)`` made earlier, else made
    here.  Returns bf16 [B,H,W,C], and with ``return_forward`` also the
    block's ``Forward`` (bf16 y1..y3, fp32 GN mean/inv-std), which B3's
    recompute must equal bit for bit.  On CUDA, C and F must be multiples
    of 64, F ≤ 512, and C/32 and F/32 must divide 64.
    """
    if not x.is_cuda:
        out = fused_bottleneck_plain(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                     eps)
        if not return_forward:
            return out
        # Imported here: that module imports this one.
        from retinanet_tpu_torch.ops.bottleneck_bwd import recompute_forward
        return out, recompute_forward(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                      eps)
    bsz, h, w, c = x.shape
    f = k1.shape[0]
    if (k1.shape != (f, c, 1, 1) or k2.shape != (f, f, 3, 3)
            or k3.shape != (c, f, 1, 1)):
        raise ValueError(f"kernel shapes {tuple(k1.shape)}, "
                         f"{tuple(k2.shape)}, {tuple(k3.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    gf, gc = resolve_groups(f), resolve_groups(c)
    if c % 64 or f % 64 or f > MAX_F or 64 % (c // gc) or 64 % (f // gf):
        raise ValueError(f"the CUDA bottleneck needs C and F divisible by "
                         f"64, F <= {MAX_F} and GN groups whose width "
                         f"divides 64, got C={c}, F={f}")
    affines = (g1, b1, g2, b2, g3, b3)
    if [t.numel() for t in affines] != [f] * 4 + [c] * 2:
        raise ValueError(f"GN affines need F={f} (GN1, GN2) and C={c} (GN3) "
                         f"elements, got {[t.numel() for t in affines]}")
    if any(t.device != x.device for t in (k1, k2, k3, *affines)):
        raise ValueError(f"kernels and GN affines must lie on {x.device}")
    check_cuda(x, "x", torch.bfloat16)
    if weights is None:
        weights = prepare_weights(k1, k2, k3)
    _check_layout(weights, ((f, c), (f, 9 * f), (c, f)), x.device)
    bf = torch.bfloat16
    gb = [t.float().contiguous() for t in affines]
    hw = h * w
    mt = -(-hw // TILE_ROWS)
    y1 = torch.empty(bsz, hw, f, dtype=bf, device=x.device)
    y2 = torch.empty_like(y1)
    y3 = torch.empty(bsz, hw, c, dtype=bf, device=x.device)
    part = torch.empty(bsz, mt, 2, max(gf, gc), dtype=torch.float32,
                       device=x.device)
    ss = torch.empty(6, bsz, c, dtype=bf, device=x.device)
    mv = (torch.empty(6, bsz, c, dtype=torch.float32, device=x.device)
          if return_forward else None)
    out = torch.empty_like(x)
    LIB.call("fused_bottleneck_fwd",
             x.data_ptr(), weights.w1.data_ptr(), gb[0].data_ptr(),
             gb[1].data_ptr(), weights.w2.data_ptr(), gb[2].data_ptr(),
             gb[3].data_ptr(), weights.w3.data_ptr(), gb[4].data_ptr(),
             gb[5].data_ptr(), y1.data_ptr(), y2.data_ptr(), y3.data_ptr(),
             part.data_ptr(), ss.data_ptr(),
             None if mv is None else mv.data_ptr(),
             tickets(x.device, bsz).data_ptr(), out.data_ptr(),
             bsz, h, w, c, f, gf, gc, float(eps), stream_ptr(x.device))
    fused_bottleneck.launches += 1
    if return_forward:
        return out, forward_of(y1, y2, y3, mv)
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
                          eps: float = 1e-5,
                          weights: Optional[ProjWeights] = None) -> Tensor:
    """One stride-1 projection block: relu(GN3(conv3(a2)) + GNp(x·kp)).

    x [B,H,W,Cin] bf16 (NHWC); kernels OIHW: k1 [F,Cin,1,1], k2 [F,F,3,3],
    k3 [C,F,1,1], kp [C,Cin,1,1]; g*/b* fp32.  ``weights``:
    ``prepare_proj_weights(k1, k2, k3, kp)`` made earlier, else made here.
    Returns bf16 [B,H,W,C].  On CUDA, Cin, F and C must be multiples of
    64, F ≤ 512, and C/32 and F/32 must divide 64.
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
    gf, gc = resolve_groups(f), resolve_groups(c)
    if (cin % 64 or f % 64 or c % 64 or f > MAX_F or 64 % (c // gc)
            or 64 % (f // gf)):
        raise ValueError(f"the CUDA projection block needs Cin, F and C "
                         f"divisible by 64, F <= {MAX_F} and GN groups "
                         f"whose width divides 64, got {cin}, {f}, {c}")
    affines = (g1, b1, g2, b2, g3, b3, gp, bp)
    if [t.numel() for t in affines] != [f] * 4 + [c] * 4:
        raise ValueError(f"GN affines need F={f} (GN1, GN2) and C={c} "
                         f"(GN3, GNp) elements, got "
                         f"{[t.numel() for t in affines]}")
    if any(t.device != x.device for t in (k1, k2, k3, kp, *affines)):
        raise ValueError(f"kernels and GN affines must lie on {x.device}")
    check_cuda(x, "x", torch.bfloat16)
    if weights is None:
        weights = prepare_proj_weights(k1, k2, k3, kp)
    _check_layout(weights, ((f + c, cin), (f, 9 * f), (c, f)), x.device)
    bf = torch.bfloat16
    gb = [t.float().contiguous() for t in affines]
    hw = h * w
    mt = -(-hw // TILE_ROWS)
    y1 = torch.empty(bsz, hw, f, dtype=bf, device=x.device)
    y2 = torch.empty_like(y1)
    y3 = torch.empty(bsz, hw, c, dtype=bf, device=x.device)
    yp = torch.empty_like(y3)
    part = torch.empty(bsz, mt, 2, gf + gc, dtype=torch.float32,
                       device=x.device)
    ss = torch.empty(8, bsz, c, dtype=bf, device=x.device)
    out = torch.empty(bsz, h, w, c, dtype=bf, device=x.device)
    PROJ_LIB.call(
        "fused_bottleneck_proj_fwd",
        x.data_ptr(), weights.w1p.data_ptr(), gb[0].data_ptr(),
        gb[1].data_ptr(), weights.w2.data_ptr(), gb[2].data_ptr(),
        gb[3].data_ptr(), weights.w3.data_ptr(), gb[4].data_ptr(),
        gb[5].data_ptr(), gb[6].data_ptr(), gb[7].data_ptr(),
        y1.data_ptr(), y2.data_ptr(), y3.data_ptr(), yp.data_ptr(),
        part.data_ptr(), ss.data_ptr(), tickets(x.device, bsz).data_ptr(),
        out.data_ptr(), bsz, h, w, cin, c, f, gf, gc, float(eps),
        stream_ptr(x.device))
    fused_bottleneck_proj.launches += 1
    return out


fused_bottleneck_proj.launches = 0
