"""Fused GroupNorm + activation (port of
``retinanet_tpu/ops/pallas/groupnorm.py:fused_group_norm_act``): kernel B4.

    out = act(x · scale + shift)   (fp32 affine, cast to x's dtype)

with per-image, per-channel ``scale``/``shift`` from fp32 Σx, Σx² group
moments (var clamped at 0).  Unlike ``models/layers.group_norm``, whose
affine runs in the input dtype, this op applies the affine in fp32, as the
TPU kernel does.  Activations are written as the TPU kernel writes them
(``_act_fn``): elu = exp(min(x,0))−1 below 0, swish = x/(1+exp(−x)), gelu
in tanh form.

``fused_group_norm_act`` is an autograd Function: its forward launches the
CUDA kernel (``csrc/groupnorm.cu``) for a CUDA tensor and runs
``fused_group_norm_act_plain`` for a CPU tensor; its backward is the plain
fp32 GroupNorm gradient of the TPU op's ``_bwd`` (the JAX package has no
backward kernel).  The module entry point is ``GroupNorm(use_kernel=True)``.

On the card the kernel takes one of two paths, a fixed rule on the shape
(``kernel_path``): "split" (a statistics launch whose last CTA per image
finalizes, then an apply launch) for any shape, or "cluster" (one launch:
a cluster of ``CLUSTER_SIZE`` CTAs per image holds the image in shared
memory, so x is read once) for small images at small batches, where it
measured faster.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
from torch import Tensor

from retinanet_tpu_torch.models.layers import gn_scale_shift
from retinanet_tpu_torch.ops.cuda import (KernelLibrary, check_cuda,
                                          stream_ptr, tickets)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = KernelLibrary("groupnorm.cu", {
    "gn_split_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    "gn_cluster_fwd": [_P] * 4 + [_I] * 7 + [_F, _P],
})

# Activation codes the CUDA side reads.
ACTIVATIONS = {None: 0, "elu": 1, "relu": 2, "relu6": 3, "swish": 4,
               "gelu": 5}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# Split path: the statistics pass aims at STATS_CTAS CTAs over the batch
# (four per SM of an H100), at least MIN_STATS_ROWS rows each; each apply
# CTA covers APPLY_BYTES of x.
STATS_CTAS, MIN_STATS_ROWS, APPLY_BYTES = 528, 16, 32 * 1024
# Cluster path: CTAs per image (16 is a non-portable cluster size), the
# kernel's threads, and the shared memory one CTA may hold; taken by
# default only where a CTA needs at most CLUSTER_FAST_SMEM and the batch's
# CTAs fit CLUSTER_WAVE (three per SM of an H100's 132).
CLUSTER_SIZE, CLUSTER_THREADS, CLUSTER_SMEM = 16, 256, 227 * 1024
CLUSTER_FAST_SMEM, CLUSTER_WAVE = 72 * 1024, 3 * 132
PATHS = ("split", "cluster")


def act_fn(activation: Optional[str]) -> Callable[[Tensor], Tensor]:
    """The TPU kernel's activation forms (``groupnorm.py:52-70``)."""
    if activation is None:
        return lambda x: x
    if activation == "elu":
        return lambda x: torch.where(
            x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)
    if activation == "relu":
        return lambda x: torch.clamp(x, min=0.0)
    if activation == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    if activation == "swish":
        return lambda x: x / (1.0 + torch.exp(-x))
    if activation == "gelu":
        return lambda x: 0.5 * x * (1.0 + torch.tanh(
            0.7978845608028654 * (x + 0.044715 * x * x * x)))
    raise ValueError(f"unsupported fused activation {activation!r}")


def fused_group_norm_act_plain(x: Tensor, gamma: Tensor, beta: Tensor,
                               groups: int, eps: float = 1e-5,
                               activation: Optional[str] = None) -> Tensor:
    """Plain PyTorch version of ``_fused_forward``: x [B,H,W,C] → x.dtype."""
    b, h, w, c = x.shape
    x32 = x.float()
    s1 = x32.sum(dim=(1, 2))
    s2 = (x32 * x32).sum(dim=(1, 2))
    scale, shift = gn_scale_shift(s1, s2, h * w, gamma, beta, groups, eps)
    y = x32 * scale[:, None, None, :] + shift[:, None, None, :]
    return act_fn(activation)(y).to(x.dtype)


def cluster_smem(hw: int, c: int, groups: int, element_size: int) -> int:
    """Shared memory of one CTA of the cluster path (``gn_cluster``): its
    mbarriers and sums, rounded to 128 bytes, then its rows of the image."""
    vec = 16 // element_size
    floats = max(2 * CLUSTER_THREADS * vec, 4 * c + 2 * groups) + 2 * c
    head = -(-(128 + 4 * floats) // 128) * 128
    return head + -(-hw // CLUSTER_SIZE) * c * element_size


def kernel_path(batch: int, hw: int, c: int, groups: int,
                dtype: torch.dtype) -> str:
    """The path B4 takes for ``batch`` images of ``hw`` pixels by ``c``
    channels: "cluster" where a CTA's share of an image fits
    CLUSTER_FAST_SMEM (three CTAs per SM) and the batch's clusters fit one
    wave (CLUSTER_WAVE CTAs), else "split".  Measured on the H100
    (``chip_smoke.py:sweep_b4_paths``): the cluster path wins only there,
    at P4 (40x40x256 bf16) at batch 8; with a fuller CTA or more waves the
    split path streams faster."""
    smem = cluster_smem(hw, c, groups, dtype.itemsize)
    fits = smem <= CLUSTER_FAST_SMEM and batch * CLUSTER_SIZE <= CLUSTER_WAVE
    return "cluster" if fits else "split"


def forward_cuda(x: Tensor, gamma: Tensor, beta: Tensor, groups: int,
                 eps: float, activation: Optional[str],
                 path: Optional[str] = None) -> Tensor:
    """B4 on the card along ``path`` (default ``kernel_path``'s)."""
    b, h, w, c = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"B4 takes bf16 or fp32, got {x.dtype}")
    vec = 16 // x.element_size()
    if c % vec or c % groups:
        raise ValueError(f"B4 needs C divisible by {vec} and by the group "
                         f"count {groups}, got C={c}")
    if gamma.numel() != c or beta.numel() != c:
        raise ValueError(f"γ/β need {c} elements, got {gamma.numel()}, "
                         f"{beta.numel()}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"γ and β must lie on {x.device}")
    check_cuda(x, "x", x.dtype)
    hw = h * w
    if hw * c >= 1 << 31:
        raise ValueError(f"B4 indexes an image with 32-bit offsets; got "
                         f"{hw}x{c} elements")
    path = path or kernel_path(b, hw, c, groups, x.dtype)
    if path not in PATHS:
        raise ValueError(f"unknown B4 path {path!r}; choose from {PATHS}")
    out = torch.empty_like(x)
    g32, b32 = gamma.float().contiguous(), beta.float().contiguous()
    dev, dt, act = x.device, _DTYPES[x.dtype], ACTIVATIONS[activation]
    stream = stream_ptr(dev)
    if path == "cluster":
        smem = cluster_smem(hw, c, groups, x.element_size())
        if smem > CLUSTER_SMEM:
            raise ValueError(f"a {h}x{w}x{c} image needs {smem} bytes of "
                             f"shared memory per CTA on the cluster path")
        LIB.call("gn_cluster_fwd", x.data_ptr(), g32.data_ptr(),
                 b32.data_ptr(), out.data_ptr(), b, hw, c, groups, dt, act,
                 CLUSTER_SIZE, float(eps), stream)
    else:
        nrb = min(-(-STATS_CTAS // b), -(-hw // MIN_STATS_ROWS))
        rows = -(-hw // nrb)
        nrb = -(-hw // rows)
        apply_rows = max(1, APPLY_BYTES // (c * x.element_size()))
        part = torch.empty(b, nrb, 2, c, dtype=torch.float32, device=dev)
        ss = torch.empty(2, b, c, dtype=torch.float32, device=dev)
        LIB.call("gn_split_fwd", x.data_ptr(), g32.data_ptr(),
                 b32.data_ptr(), part.data_ptr(), tickets(dev, b).data_ptr(),
                 ss.data_ptr(), out.data_ptr(), b, hw, c, groups, dt, act,
                 rows, apply_rows, float(eps), stream)
    fused_group_norm_act.launches += 1
    return out


def group_norm_act_grad(x: Tensor, gamma: Tensor, beta: Tensor, groups: int,
                        eps: float, activation: Optional[str], g: Tensor):
    """The TPU op's ``_bwd``: the standard fp32 GroupNorm gradient after
    the activation's, from the primals (dx in x's dtype, dγ/dβ fp32)."""
    n, h, w, c = x.shape
    cg = c // groups
    xg = x.float().reshape(n, h * w, groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = ((xg - mean) * inv).reshape(n, h, w, c)
    z = xhat * gamma.float() + beta.float()
    g32 = g.float()
    if activation is None:
        dz = g32
    elif activation == "relu":
        dz = g32 * (z > 0)
    elif activation == "elu":
        dz = g32 * torch.where(z > 0, 1.0, torch.exp(torch.clamp(z, max=0.0)))
    elif activation == "relu6":
        dz = g32 * ((z > 0) & (z < 6))
    else:
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (dz,) = torch.autograd.grad(act_fn(activation)(zz), zz, g32)
    dgamma = (dz * xhat).sum(dim=(0, 1, 2))
    dbeta = dz.sum(dim=(0, 1, 2))
    dxhat = (dz * gamma.float()).reshape(n, h * w, groups, cg)
    xhat_g = xhat.reshape(n, h * w, groups, cg)
    m = h * w * cg
    sum_dxhat = dxhat.sum(dim=(1, 3), keepdim=True)
    sum_dxhat_xhat = (dxhat * xhat_g).sum(dim=(1, 3), keepdim=True)
    dx = (inv / m) * (m * dxhat - sum_dxhat - xhat_g * sum_dxhat_xhat)
    return (dx.reshape(n, h, w, c).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


def _forward(x: Tensor, gamma: Tensor, beta: Tensor, groups: int,
             eps: float, activation: Optional[str]) -> Tensor:
    """B4 for a CUDA tensor, its plain version for a CPU tensor."""
    if not x.is_cuda:
        return fused_group_norm_act_plain(x, gamma, beta, groups, eps,
                                          activation)
    return forward_cuda(x, gamma, beta, groups, eps, activation)


class FusedGroupNormAct(torch.autograd.Function):
    """Forward: ``_forward``; backward: the plain fp32 gradient,
    recomputed from the saved primals."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, activation):
        ctx.save_for_backward(x, gamma, beta)
        ctx.config = (groups, eps, activation)
        return _forward(x, gamma, beta, groups, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_act_grad(x, gamma, beta, *ctx.config,
                                                g)
        return dx, dgamma, dbeta, None, None, None


def fused_group_norm_act(x: Tensor, gamma: Tensor, beta: Tensor, groups: int,
                         eps: float = 1e-5,
                         activation: Optional[str] = None) -> Tensor:
    """act(GroupNorm(x)·γ + β) of x [B,H,W,C] (NHWC, bf16 or fp32) with
    ``groups`` groups; γ/β [C].  Returns x's dtype and shape."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return FusedGroupNormAct.apply(x, gamma, beta, groups, eps,
                                       activation)
    # Nothing to differentiate (serving): the forward without the autograd
    # Function's bookkeeping, a host cost of each call.
    return _forward(x, gamma, beta, groups, eps, activation)


fused_group_norm_act.launches = 0
