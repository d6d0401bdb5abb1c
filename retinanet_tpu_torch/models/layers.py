"""Shared layers (port of ``retinanet_tpu/models/layers.py``).

Tensors are NCHW in ``channels_last`` memory.  Parameters are created in
float32 under the flax names (``kernel`` OIHW, ``bias``, ``gamma``,
``beta``) so a flax leaf path maps onto a ``state_dict`` key by replacing
``/`` with ``.``; convolutions cast the kernel to the input dtype at use,
as the JAX ``Conv`` does, and GroupNorm keeps γ/β in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from retinanet_tpu_torch.ops.cuda import ParameterCache


def get_activation(name: str) -> Callable[[Tensor], Tensor]:
    """Activation registry; ``gelu`` is the tanh form, as ``jax.nn.gelu``."""
    return {
        "elu": F.elu,
        "relu": F.relu,
        "relu6": F.relu6,
        "swish": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def resolve_groups(c: int, groups: int = 32) -> int:
    """GroupNorm group count: ``min(groups, c)``, then the largest divisor
    of ``c`` (the JAX package's single policy; tested equal to it)."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def gn_scale_shift(s1: Tensor, s2: Tensor, hw: int, gamma: Tensor,
                   beta: Tensor, groups: int, eps: float
                   ) -> Tuple[Tensor, Tensor]:
    """Per-image float32 (scale, shift) ``[N, C]`` of the GN affine
    ``y * scale + shift`` from per-channel fp32 sums Σy, Σy² over ``hw``
    pixels: group moments, var = E[y²]−E[y]² clamped at 0, then rsqrt."""
    n, c = s1.shape
    cg = c // groups
    cnt = hw * cg
    mean = s1.view(n, groups, cg).sum(-1, keepdim=True) / cnt
    var = torch.clamp(
        s2.view(n, groups, cg).sum(-1, keepdim=True) / cnt - mean * mean,
        min=0.0)
    inv = torch.rsqrt(var + eps)
    gamma_g = gamma.float().view(1, groups, cg)
    beta_g = beta.float().view(1, groups, cg)
    scale = (inv * gamma_g).view(n, c)
    shift = (beta_g - mean * inv * gamma_g).view(n, c)
    return scale, shift


def group_norm(x: Tensor, gamma: Tensor, beta: Tensor, groups: int,
               eps: float = 1e-5, activation: Optional[str] = None) -> Tensor:
    """Two-pass GroupNorm of an NCHW tensor (``layers.py:139-168``): fp32
    per-channel Σx and Σx², then scale and shift cast to the input dtype
    and the affine applied in that dtype."""
    n, c, h, w = x.shape
    x32 = x.float()
    s1 = x32.sum(dim=(2, 3))
    s2 = (x32 * x32).sum(dim=(2, 3))
    scale, shift = gn_scale_shift(s1, s2, h * w, gamma, beta,
                                  resolve_groups(c, groups), eps)
    out = (x * scale.to(x.dtype)[:, :, None, None]
           + shift.to(x.dtype)[:, :, None, None])
    if activation is not None:
        out = get_activation(activation)(out)
    return out


# Smallest h·w·c that takes kernel B4 under ``use_kernel`` (the JAX
# module's gate, ``layers.py:124``).
GN_KERNEL_MIN_ELEMENTS = 1 << 18


class GroupNorm(nn.Module):
    """GroupNorm with γ/β in float32 and an optional fused activation.

    ``use_kernel`` is the counterpart of the JAX module's ``use_pallas``
    (off by default; no config sets it): a CUDA tensor with h·w·c ≥ 2¹⁸
    goes through kernel B4 (``ops/groupnorm.fused_group_norm_act``), whose
    affine runs in fp32; anything else takes ``group_norm``, as the JAX
    module takes its jnp path off the TPU."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 activation: Optional[str] = None, use_kernel: bool = False):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.activation = activation
        self.use_kernel = use_kernel
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        n, c, h, w = x.shape
        if (self.use_kernel and x.is_cuda
                and h * w * c >= GN_KERNEL_MIN_ELEMENTS):
            # Imported here: the op module imports this one.
            from retinanet_tpu_torch.ops.groupnorm import fused_group_norm_act
            out = fused_group_norm_act(
                x.permute(0, 2, 3, 1).contiguous(), self.gamma, self.beta,
                resolve_groups(c, self.groups), self.eps, self.activation)
            return out.permute(0, 3, 1, 2)
        return group_norm(x, self.gamma, self.beta, self.groups, self.eps,
                          self.activation)


def use_group_norm_kernel(model: nn.Module, on: bool = True) -> int:
    """Set ``use_kernel`` on every ``GroupNorm`` of ``model`` (the JAX
    module's ``use_pallas``, for a whole model; no config sets it).
    Returns the number of modules set."""
    mods = [m for m in model.modules() if isinstance(m, GroupNorm)]
    for m in mods:
        m.use_kernel = on
    return len(mods)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA "SAME" (before, after) padding of one spatial dim; the extra
    element goes after, so stride 2 is asymmetric."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC-semantics conv with TF "SAME" padding, kernel stored OIHW in
    float32 and cast to the input dtype at use; the optional bias is added
    after the conv output is rounded, as in the JAX ``Conv``.

    ``quantize`` runs the conv as ``ops/int8_conv.int8_conv`` (int8
    serving: kernel B6 on the card) with the output in x's dtype, then the
    bias in that dtype; the parameters are the float model's, and their
    quantized form is kept per version of the kernel (``ParameterCache``
    of ``int8_conv.prepare_weights``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, use_bias: bool = False,
                 kernel_init: str = "he_normal", bias_init: float = 0.0,
                 quantize: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.strides = strides
        self.quantize = quantize
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.kernel = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._int8_weights: Optional[ParameterCache] = None

    def weight_as(self, x: Tensor) -> Tensor:
        return self.kernel.to(dtype=x.dtype,
                              memory_format=torch.channels_last)

    def forward(self, x: Tensor) -> Tensor:
        k, s = self.kernel_size, self.strides
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if self.quantize:
            # Imported here: the op module imports this one.
            from retinanet_tpu_torch.ops import int8_conv as b6
            if self._int8_weights is None:
                self._int8_weights = ParameterCache(b6.prepare_weights)
            y = b6.int8_conv(x.permute(0, 2, 3, 1).contiguous(), self.kernel,
                             s, x.dtype, weights=self._int8_weights(
                                 self.kernel)).permute(0, 3, 1, 2)
        elif (top, left) == (bottom, right):
            y = F.conv2d(x, self.weight_as(x), stride=s, padding=(top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)),
                         self.weight_as(x), stride=s)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


class ConvGN(nn.Module):
    """conv (no bias) → GroupNorm → optional activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, gn_groups: int = 32,
                 activation: Optional[str] = None,
                 kernel_init: str = "he_normal", quantize: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel_size, strides,
                           kernel_init=kernel_init, quantize=quantize)
        self.GroupNorm_0 = GroupNorm(features, gn_groups,
                                     activation=activation)

    def forward(self, x: Tensor) -> Tensor:
        return self.GroupNorm_0(self.Conv_0(x))


def max_pool_same(x: Tensor, window: int, strides: int) -> Tensor:
    """Max pool with TF "SAME" padding by −inf (the stem's 3×3/2 pool pads
    0 before and 1 after on an even side)."""
    top, bottom = same_padding(x.shape[2], window, strides)
    left, right = same_padding(x.shape[3], window, strides)
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, window, strides)


def nearest_upsample(x: Tensor, target_hw: Sequence[int]) -> Tensor:
    """Nearest resize with half-pixel centres, as ``jax.image.resize(...,
    "nearest")``; at exactly 2× this is a repeat of every pixel."""
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
