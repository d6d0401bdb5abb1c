"""Backward of the fused identity bottleneck (port of
``retinanet_tpu/ops/pallas/bottleneck_bwd.py``: ``fused_bottleneck_bwd``
and the custom VJP ``fused_bottleneck_train``).

``fused_bottleneck_bwd`` launches the hand-written CUDA kernel
(``csrc/bottleneck_bwd.cu``) for CUDA tensors and runs
``fused_bottleneck_bwd_plain`` for CPU tensors; neither falls back to the
other.  Both recompute the forward from the block input and compute the
seven passes of the TPU kernel at its rounding points: bf16 cotangents
between ops (dn3, dn2, dn1 and each GN backward's dy), products accumulated
in fp32, GN sums and every parameter gradient in fp32.

The kernel reads six bf16 layouts of the three conv kernels (``w1``,
``w1t``, ``w2``, ``w2r``, ``w3``, ``w3t``), which ``prepare_weights``
builds on every call: the optimizer updates the kernels in place after
every step, so a copy kept between calls would be rebuilt each time.  The
CUDA kernel recomputes y1..y3 with B1's own GEMM kernels, launched as B1
launches them (bitwise B1's forward), writes the relu(GN affine) planes
a1, a2 once, and runs its dgrad and weight-gradient GEMMs on wgmma from a
ring of asynchronous copies (the source note of ``csrc/bottleneck_bwd.cu``).

``FusedBottleneckTrain`` (``fused_bottleneck_train``) is the autograd
Function of the training path: its forward is B1 (``ops/bottleneck.py``,
with the layouts ``ResNetBottleneck`` keeps, which every optimizer step
renews) and it saves only the primals, x and the nine parameters; its
backward is ``fused_bottleneck_bwd``.  Gradients come back in the port's shapes: OIHW
kernels and GN vectors in fp32, ``dx`` bf16 NHWC.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from retinanet_tpu_torch.models.layers import resolve_groups
from retinanet_tpu_torch.ops.bottleneck import (MAX_F, BlockWeights,
                                                Forward, forward_of,
                                                fused_bottleneck, tickets)
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary("bottleneck_bwd.cu", {
    "fused_bottleneck_bwd": [_P] * 38 + [_I] * 10 + [ctypes.c_float, _P],
})

# Upper bound on the K-slices of a weight-gradient GEMM, the number of CTAs
# the slicing aims for (four waves of 132 SMs), and the rows of K per
# k-step of its tiles.
_MAX_SLICES = 128
_TARGET_CTAS = 528
_WGRAD_BK = 64

Grads = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
              Tensor, Tensor]


def _moments(y: Tensor, groups: int, eps: float,
             acc: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Per-channel (mean, inv-std) [B, C] of GN over a [B, M, C] plane, in
    ``acc``: Σy and Σy² of the (rounded) values, var = E[y²] − E[y]²
    clamped at 0."""
    b, m, c = y.shape
    cg = c // groups
    y32 = y.to(acc)
    s1 = y32.sum(1).view(b, groups, cg).sum(-1, keepdim=True)
    s2 = (y32 * y32).sum(1).view(b, groups, cg).sum(-1, keepdim=True)
    mean = s1 / (m * cg)
    var = torch.clamp(s2 / (m * cg) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (mean.expand(b, groups, cg).reshape(b, c),
            inv.expand(b, groups, cg).reshape(b, c))


def _affine(y: Tensor, mean: Tensor, inv: Tensor, gamma: Tensor,
            beta: Tensor) -> Tensor:
    """GN affine ``y * scale + shift`` in y's type (bf16: each op rounds)
    with scale = inv·γ, shift = β − mean·inv·γ per image."""
    g = gamma.to(mean.dtype)
    scale = (inv * g).to(y.dtype)[:, None, :]
    shift = (beta.to(mean.dtype) - mean * inv * g).to(y.dtype)[:, None, :]
    return y * scale + shift


def _gn_backward(d: Tensor, y: Tensor, mean: Tensor, inv: Tensor,
                 gamma: Tensor, groups: int):
    """GN backward from the cotangent ``d`` of the affine's output: returns
    (dy in d's type, per-image Σd·ŷ [B, C], per-image Σd [B, C])."""
    b, m, c = y.shape
    cg = c // groups
    d32 = d.to(mean.dtype)
    yhat = (y.to(mean.dtype) - mean[:, None]) * inv[:, None]
    sb = d32.sum(1)
    sg = (d32 * yhat).sum(1)
    g = gamma.to(mean.dtype)
    n = m * cg

    def group_mean(s: Tensor) -> Tensor:
        t = (g * s).view(b, groups, cg).sum(-1, keepdim=True) / n
        return t.expand(b, groups, cg).reshape(b, c)[:, None]

    t1, t2 = group_mean(sb), group_mean(sg)
    dy = (inv[:, None] * (g * d32 - t1 - yhat * t2)).to(d.dtype)
    return dy, sg, sb


def recompute_forward(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                      k2: Tensor, g2: Tensor, b2: Tensor, k3: Tensor,
                      g3: Tensor, b3: Tensor, eps: float = 1e-5,
                      dtype: torch.dtype = torch.bfloat16) -> Forward:
    """P1-P3 of the plain version: the forward, rounded as B1 rounds it.

    Returns the conv outputs y1, y2 [B,HW,F] and y3 [B,HW,C] in ``dtype``
    (products summed in fp32, float64 for ``dtype=torch.float64``) and
    each GN's (mean, inv-std) [B, F or C] in that sum type.
    """
    bf = dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    bsz, h, w, c = x.shape
    f = k1.shape[0]
    gf, gc = resolve_groups(f), resolve_groups(c)
    xm = x.reshape(bsz, h * w, c).to(bf)
    y1 = (xm.to(acc) @ k1.reshape(f, c).to(bf).t().to(acc)).to(bf)
    mean1, inv1 = _moments(y1, gf, eps, acc)
    a1 = torch.relu(_affine(y1, mean1, inv1, g1, b1))
    a1_img = a1.view(bsz, h, w, f).permute(0, 3, 1, 2).to(acc)
    y2 = F.conv2d(a1_img, k2.to(bf).to(acc), padding=1).permute(0, 2, 3, 1)
    y2 = y2.reshape(bsz, h * w, f).to(bf)
    mean2, inv2 = _moments(y2, gf, eps, acc)
    a2 = torch.relu(_affine(y2, mean2, inv2, g2, b2))
    y3 = (a2.to(acc) @ k3.reshape(c, f).to(bf).t().to(acc)).to(bf)
    mean3, inv3 = _moments(y3, gc, eps, acc)
    return y1, y2, y3, ((mean1, inv1), (mean2, inv2), (mean3, inv3))


def relu_inputs(x: Tensor, forward: Forward, g1: Tensor, b1: Tensor,
                g2: Tensor, b2: Tensor, g3: Tensor, b3: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The values the block's three relus test, from a forward: n1 =
    GN1(y1), n2 = GN2(y2) [B,HW,F] and GN3(y3) + x [B,HW,C] (a bf16 add
    in bf16).  Their signs are the backward's masks."""
    y1, y2, y3, ((mean1, inv1), (mean2, inv2), (mean3, inv3)) = forward
    xm = x.reshape(y3.shape).to(y3.dtype)
    return (_affine(y1, mean1, inv1, g1, b1), _affine(y2, mean2, inv2, g2, b2),
            _affine(y3, mean3, inv3, g3, b3) + xm)


def fused_bottleneck_bwd_plain(x: Tensor, dout: Tensor, k1: Tensor,
                               g1: Tensor, b1: Tensor, k2: Tensor,
                               g2: Tensor, b2: Tensor, k3: Tensor,
                               g3: Tensor, b3: Tensor, eps: float = 1e-5,
                               dtype: torch.dtype = torch.bfloat16,
                               forward: Optional[Forward] = None) -> Grads:
    """Plain PyTorch version of the seven passes, whole image at a time.

    ``dtype`` is the working type of activations and cotangents: bf16
    rounds where the kernel rounds, with products summed in fp32;
    ``torch.float64`` rounds nowhere and gives the block's exact gradient
    (a ground truth for both).  Not autograd through
    ``fused_bottleneck_plain``: autograd reduces the GN β/γ cotangents
    elsewhere and in another precision.

    ``forward`` replaces P1-P3 (``recompute_forward``) with a given
    forward, such as the kernel's own (``fused_bottleneck_bwd(...,
    return_forward=True)``): the relu masks are then the kernel's, and
    only the order of the fp32 sums parts the two versions.
    """
    bf = dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    bsz, h, w, c = x.shape
    f = k1.shape[0]
    gf, gc = resolve_groups(f), resolve_groups(c)
    m = h * w
    w1 = k1.reshape(f, c).to(bf)
    w2 = k2.to(bf)
    w3 = k3.reshape(c, f).to(bf)
    xm = x.reshape(bsz, m, c).to(bf)
    dout = dout.to(bf).reshape(bsz, m, c)

    def mm(a: Tensor, b: Tensor) -> Tensor:
        return a.to(acc) @ b.to(acc)

    # P1-P3: the forward, rounded as B1 rounds it.
    if forward is None:
        forward = recompute_forward(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                    eps, dtype)
    y1, y2, y3, ((mean1, inv1), (mean2, inv2), (mean3, inv3)) = forward
    n1, n2, pre = relu_inputs(x, forward, g1, b1, g2, b2, g3, b3)
    a1_img = torch.relu(n1).view(bsz, h, w, f).permute(0, 3, 1, 2).to(acc)
    a2 = torch.relu(n2)

    # P4: output relu mask; GN3 backward.
    dn3 = torch.where(pre > 0, dout, torch.zeros_like(dout))
    dy3, dg3, db3 = _gn_backward(dn3, y3, mean3, inv3, g3, gc)

    # P5: conv3 dgrad masked by GN2 -> dn2; dk3 = dy3ᵀ·a2.
    da2 = mm(dy3, w3).to(bf)
    dn2 = torch.where(n2 > 0, da2, torch.zeros_like(da2))
    dk3 = mm(dy3.reshape(-1, c).t(), a2.reshape(-1, f))
    dy2, dg2, db2 = _gn_backward(dn2, y2, mean2, inv2, g2, gf)

    # P6: conv2 dgrad (zero cotangent outside the image) masked by GN1;
    # dk2 from the a1 taps (zeros outside the image after the affine).
    dy2_img = dy2.view(bsz, h, w, f).permute(0, 3, 1, 2).to(acc)
    da1 = F.conv_transpose2d(dy2_img, w2.to(acc), padding=1)
    da1 = da1.permute(0, 2, 3, 1).reshape(bsz, m, f).to(bf)
    dn1 = torch.where(n1 > 0, da1, torch.zeros_like(da1))
    dk2 = torch.nn.grad.conv2d_weight(a1_img, tuple(k2.shape), dy2_img,
                                      padding=1)
    dy1, dg1, db1 = _gn_backward(dn1, y1, mean1, inv1, g1, gf)

    # P7: dx = bf16(dy1·k1ᵀ) + dn3 (a bf16 add); dk1 = dy1ᵀ·x.
    dx = mm(dy1, w1).to(bf) + dn3
    dk1 = mm(dy1.reshape(-1, f).t(), xm.reshape(-1, c))
    return (dx.reshape(bsz, h, w, c), dk1.reshape(k1.shape), dg1.sum(0),
            db1.sum(0), dk2, dg2.sum(0), db2.sum(0), dk3.reshape(k3.shape),
            dg3.sum(0), db3.sum(0))


def prepare_weights(k1: Tensor, k2: Tensor, k3: Tensor
                    ) -> Tuple[Tensor, ...]:
    """B3's six bf16 weight layouts of the OIHW kernels k1 [F,C,1,1], k2
    [F,F,3,3], k3 [C,F,1,1]: w1 [F,C] and w1t [C,F]; w2 [F,9F] (out, tap,
    in) and w2r [F,9F] (in, reversed tap, out) for conv2's dgrad; w3 [C,F]
    and w3t [F,C]."""
    bf = torch.bfloat16
    f, c = k1.shape[:2]
    w1 = k1.reshape(f, c).to(bf).contiguous()
    w3 = k3.reshape(c, f).to(bf).contiguous()
    return (
        w1, w1.t().contiguous(),
        k2.to(bf).permute(0, 2, 3, 1).reshape(f, 9 * f).contiguous(),
        k2.to(bf).flip(2, 3).permute(1, 2, 3, 0).reshape(f, 9 * f)
        .contiguous(),
        w3, w3.t().contiguous())


def _tile(n: int) -> int:
    """The weight-gradient tile along a channel dimension: 128, or 64
    where it does not divide (the C side's choice)."""
    return 128 if n % 128 == 0 else 64


def _slices(rows_m: int, cols_n: int, taps: int, k_rows: int) -> int:
    """K-slices of a weight-gradient GEMM: enough CTAs to fill the card,
    at most one per k-step of ``_WGRAD_BK`` rows and at most
    ``_MAX_SLICES``."""
    tiles = (rows_m // _tile(rows_m)) * (cols_n // _tile(cols_n)) * taps
    k_steps = -(-k_rows // _WGRAD_BK)
    return max(1, min(k_steps, _MAX_SLICES, -(-_TARGET_CTAS // tiles)))


def fused_bottleneck_bwd(x: Tensor, dout: Tensor, k1: Tensor, g1: Tensor,
                         b1: Tensor, k2: Tensor, g2: Tensor, b2: Tensor,
                         k3: Tensor, g3: Tensor, b3: Tensor,
                         eps: float = 1e-5, return_forward: bool = False
                         ) -> Union[Grads, Tuple[Grads, Forward]]:
    """Gradients of ``fused_bottleneck`` with respect to every input.

    x, dout [B,H,W,C] bf16 (NHWC); kernels OIHW as the port stores them:
    k1 [F,C,1,1], k2 [F,F,3,3], k3 [C,F,1,1]; g*/b* the GN affines.  Returns
    ``(dx, dk1, dg1, db1, dk2, dg2, db2, dk3, dg3, db3)``: dx bf16, the rest
    fp32 in the parameters' shapes.  On CUDA, C and F must be multiples of
    64.  ``return_forward`` also returns the forward the backward
    recomputed (a ``Forward``: bf16 y1..y3, fp32 GN mean/inv), for holding
    the plain version to the same relu masks.
    """
    if not x.is_cuda:
        grads = fused_bottleneck_bwd_plain(x, dout, k1, g1, b1, k2, g2, b2,
                                           k3, g3, b3, eps)
        if return_forward:
            return grads, recompute_forward(x, k1, g1, b1, k2, g2, b2, k3,
                                            g3, b3, eps)
        return grads
    bsz, h, w, c = x.shape
    f = k1.shape[0]
    if (k1.shape != (f, c, 1, 1) or k2.shape != (f, f, 3, 3)
            or k3.shape != (c, f, 1, 1)):
        raise ValueError(f"kernel shapes {tuple(k1.shape)}, "
                         f"{tuple(k2.shape)}, {tuple(k3.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if (c % 64 or f % 64 or f > MAX_F or 64 % (c // resolve_groups(c))
            or 64 % (f // resolve_groups(f))):
        raise ValueError(f"the CUDA bottleneck backward needs C and F "
                         f"divisible by 64, F <= {MAX_F} and GN groups whose "
                         f"width divides 64, got C={c}, F={f}")
    if dout.shape != x.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match x "
                         f"{tuple(x.shape)}")
    affines = (g1, b1, g2, b2, g3, b3)
    if [t.numel() for t in affines] != [f] * 4 + [c] * 2:
        raise ValueError(f"GN affines need F={f} (GN1, GN2) and C={c} (GN3) "
                         f"elements, got {[t.numel() for t in affines]}")
    if any(t.device != x.device for t in (dout, k1, k2, k3, *affines)):
        raise ValueError(f"dout, kernels and GN affines must lie on "
                         f"{x.device}")
    check_cuda(x, "x", torch.bfloat16)
    check_cuda(dout, "dout", torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    dev = x.device
    w1, w1t, w2, w2r, w3, w3t = prepare_weights(k1, k2, k3)
    gb = [t.float().contiguous() for t in affines]
    hw = h * w
    rows = bsz * hw
    mt = -(-hw // 64)
    s1 = _slices(f, c, 1, rows)
    s2 = _slices(f, f, 9, rows)
    s3 = _slices(c, f, 1, rows)
    y1 = torch.empty(bsz, hw, f, dtype=bf, device=dev)
    y2 = torch.empty_like(y1)
    y3 = torch.empty(bsz, hw, c, dtype=bf, device=dev)
    planes = torch.empty(2, bsz, hw, f, dtype=bf, device=dev)
    part = torch.empty(bsz, mt, 2, c, dtype=f32, device=dev)
    ss = torch.empty(6, bsz, c, dtype=bf, device=dev)
    mv = torch.empty(6, bsz, c, dtype=f32, device=dev)
    dn3 = torch.empty_like(y3)
    dn21 = torch.empty_like(y1)
    dyb = torch.empty_like(y3)
    tt = torch.empty(2, bsz, c, dtype=f32, device=dev)
    gimg = torch.empty(6, bsz, c, dtype=f32, device=dev)
    wpart = torch.empty(max(s1 * f * c, s2 * 9 * f * f, s3 * c * f),
                        dtype=f32, device=dev)
    dx = torch.empty_like(x)
    dk1 = torch.empty(k1.shape, dtype=f32, device=dev)
    dk2 = torch.empty(k2.shape, dtype=f32, device=dev)
    dk3 = torch.empty(k3.shape, dtype=f32, device=dev)
    dgb = [torch.empty(f, dtype=f32, device=dev) for _ in range(4)] + [
        torch.empty(c, dtype=f32, device=dev) for _ in range(2)]
    LIB.call("fused_bottleneck_bwd",
             x.data_ptr(), dout.data_ptr(), w1.data_ptr(), w1t.data_ptr(),
             gb[0].data_ptr(), gb[1].data_ptr(), w2.data_ptr(),
             w2r.data_ptr(), gb[2].data_ptr(), gb[3].data_ptr(),
             w3.data_ptr(), w3t.data_ptr(), gb[4].data_ptr(),
             gb[5].data_ptr(), y1.data_ptr(), y2.data_ptr(), y3.data_ptr(),
             planes.data_ptr(), part.data_ptr(), ss.data_ptr(),
             mv.data_ptr(), dn3.data_ptr(), dn21.data_ptr(), dyb.data_ptr(),
             tt.data_ptr(), gimg.data_ptr(), wpart.data_ptr(),
             tickets(dev, bsz).data_ptr(), dx.data_ptr(), dk1.data_ptr(), dk2.data_ptr(),
             dk3.data_ptr(), *(t.data_ptr() for t in dgb),
             bsz, h, w, c, f, resolve_groups(f), resolve_groups(c),
             s1, s2, s3, float(eps), stream_ptr(dev))
    fused_bottleneck_bwd.launches += 1
    dg1, db1, dg2, db2, dg3, db3 = (t.view(p.shape) for t, p in
                                    zip(dgb, affines))
    grads = dx, dk1, dg1, db1, dk2, dg2, db2, dk3, dg3, db3
    if not return_forward:
        return grads
    return grads, forward_of(y1, y2, y3, mv)


fused_bottleneck_bwd.launches = 0


class FusedBottleneckTrain(torch.autograd.Function):
    """Identity bottleneck for training: B1 forward, B3 backward.  Saves
    only the primals; the backward recomputes every intermediate."""

    @staticmethod
    def forward(ctx, x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                k2: Tensor, g2: Tensor, b2: Tensor, k3: Tensor, g3: Tensor,
                b3: Tensor, eps: float = 1e-5,
                weights: Optional[BlockWeights] = None) -> Tensor:
        ctx.save_for_backward(x, k1, g1, b1, k2, g2, b2, k3, g3, b3)
        ctx.eps = eps
        return fused_bottleneck(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, eps,
                                weights)

    @staticmethod
    def backward(ctx, dout: Tensor):
        # dout arrives as a view of an NCHW gradient: make it contiguous
        # NHWC, as the kernel reads it.
        x, *params = ctx.saved_tensors
        dx, *dparams = fused_bottleneck_bwd(x, dout.contiguous(), *params,
                                            eps=ctx.eps)
        return (dx, *dparams, None, None)


def fused_bottleneck_train(x: Tensor, k1: Tensor, g1: Tensor, b1: Tensor,
                           k2: Tensor, g2: Tensor, b2: Tensor, k3: Tensor,
                           g3: Tensor, b3: Tensor, eps: float = 1e-5,
                           weights: Optional[BlockWeights] = None
                           ) -> Tensor:
    """``fused_bottleneck`` with the hand-written backward as its
    gradient (the JAX package's custom VJP); ``weights`` as for
    ``fused_bottleneck``."""
    return FusedBottleneckTrain.apply(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                      eps, weights)
