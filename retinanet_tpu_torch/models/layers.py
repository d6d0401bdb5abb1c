"""Shared layers (port of ``retinanet_tpu/models/layers.py``).

Tensors are NCHW in ``channels_last`` memory.  Parameters are created in
float32 under the flax names (``kernel`` OIHW, ``bias``, ``gamma``,
``beta``) so a flax leaf path maps onto a ``state_dict`` key by replacing
``/`` with ``.``; convolutions cast the kernel to the input dtype at use,
as the JAX ``Conv`` does, and GroupNorm keeps γ/β in float32.
``Dropout`` draws its masks from an explicit per-forward ``DropoutKeys``,
never from the global generator.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from retinanet_tpu_torch.ops.cuda import ParameterCache
from retinanet_tpu_torch.ops.grouped import block_diagonal

# Trace-time override (the JAX module's ``_FORCE_TRUE_GROUPED``): grouped
# convs keep their true group count even where ``grouped_as_dense`` would
# run them as a block-diagonal dense conv.  Only the analytic FLOP count
# (``infer.forward_gflops_per_image(algorithmic=True)``) sets it.
_FORCE_TRUE_GROUPED = False


class force_true_grouped:
    """Context manager setting :data:`_FORCE_TRUE_GROUPED` for a trace."""

    def __enter__(self):
        global _FORCE_TRUE_GROUPED
        _FORCE_TRUE_GROUPED = True

    def __exit__(self, *exc):
        global _FORCE_TRUE_GROUPED
        _FORCE_TRUE_GROUPED = False


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

    ``feature_group_count`` g makes the kernel ``[F, C/g, kh, kw]`` (flax's
    HWIO ``[kh, kw, C/g, F]``).  With ``grouped_as_dense``, a grouped conv
    whose input width equals F runs as its ``block_diagonal`` dense form
    (the JAX module's rule, kept so that the FLOP count matches it), unless
    ``force_true_grouped`` is on; otherwise ``F.conv2d(groups=g)``.

    ``quantize`` runs the conv as ``ops/int8_conv.int8_conv`` (int8
    serving: kernel B6 on the card, which takes a grouped kernel as its
    block-diagonal dense form) with the output in x's dtype, then the bias
    in that dtype; the parameters are the float model's, and their
    quantized form is kept per version of the kernel (``ParameterCache``
    of ``int8_conv.prepare_weights``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, use_bias: bool = False,
                 kernel_init: str = "he_normal", bias_init: float = 0.0,
                 quantize: bool = False, feature_group_count: int = 1,
                 grouped_as_dense: bool = False):
        super().__init__()
        if in_channels % feature_group_count or \
                features % feature_group_count:
            raise ValueError(f"{feature_group_count} groups do not divide "
                             f"{in_channels} -> {features} channels")
        self.kernel_size = kernel_size
        self.strides = strides
        self.quantize = quantize
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.feature_group_count = feature_group_count
        self.grouped_as_dense = grouped_as_dense
        self.kernel = nn.Parameter(torch.empty(
            features, in_channels // feature_group_count, kernel_size,
            kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._int8_weights: Optional[ParameterCache] = None

    def weight_as(self, x: Tensor) -> Tensor:
        return self.kernel.to(dtype=x.dtype,
                              memory_format=torch.channels_last)

    def _float_weight(self, x: Tensor) -> Tuple[Tensor, int]:
        """(the kernel in x's dtype, the group count) the float conv runs."""
        groups = self.feature_group_count
        if (self.grouped_as_dense and not _FORCE_TRUE_GROUPED and groups > 1
                and x.shape[1] == self.kernel.shape[0]):
            dense = block_diagonal(self.kernel, groups)
            return dense.to(dtype=x.dtype,
                            memory_format=torch.channels_last), 1
        return self.weight_as(x), groups

    def forward(self, x: Tensor) -> Tensor:
        k, s = self.kernel_size, self.strides
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if self.quantize:
            # Imported here: the op module imports this one.
            from retinanet_tpu_torch.ops import int8_conv as b6
            if self._int8_weights is None:
                self._int8_weights = ParameterCache(functools.partial(
                    b6.prepare_weights, groups=self.feature_group_count))
            y = b6.int8_conv(x.permute(0, 2, 3, 1).contiguous(), self.kernel,
                             s, x.dtype, weights=self._int8_weights(
                                 self.kernel),
                             groups=self.feature_group_count
                             ).permute(0, 3, 1, 2)
        else:
            weight, groups = self._float_weight(x)
            if (top, left) == (bottom, right):
                y = F.conv2d(x, weight, stride=s, padding=(top, left),
                             groups=groups)
            else:
                y = F.conv2d(F.pad(x, (left, right, top, bottom)), weight,
                             stride=s, groups=groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


def _mix64(z: int) -> int:
    """SplitMix64's finalizer: a bijective scramble of a 64-bit word."""
    mask = (1 << 64) - 1
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & mask
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & mask
    return z ^ (z >> 31)


class DropoutKeys:
    """The dropout randomness of one forward: one seed drawn from the
    caller's generator, folded with each dropout site's index (as JAX folds
    a key), so that a site draws the same mask every time the forward
    runs it, a recomputation under ``torch.utils.checkpoint`` included
    (which restores only the global generators' state).  One generator
    per device serves every site, re-seeded for each draw."""

    def __init__(self, seed: int):
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}

    @classmethod
    def draw(cls, generator: torch.Generator) -> "DropoutKeys":
        """One seed from ``generator`` (a CPU generator draws without
        synchronising with the card)."""
        return cls(int(torch.randint(0, 1 << 62, (), generator=generator,
                                     device=generator.device)))

    def generator(self, site: int, device: torch.device) -> torch.Generator:
        """This forward's generator on ``device``, seeded by (seed, site);
        valid until the next call (``manual_seed`` restarts its stream)."""
        seed = _mix64(self.seed * 0x9E3779B97F4A7C15 + site
                      & (1 << 64) - 1) >> 1
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device)
        return gen.manual_seed(seed)


def dropout(x: Tensor, rate: float, generator: torch.Generator) -> Tensor:
    """flax's ``Dropout`` when training: keep an element with probability
    1 − rate (one uniform draw per element from ``generator``) and return
    ``x / (1 − rate)`` computed in x's dtype (1 − rate rounded to it), else
    0.  Rate 1 gives zeros.  The mask is drawn NHWC, the layout of x's
    memory, so the result stays ``channels_last``."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    n, c, h, w = x.shape
    u = torch.rand((n, h, w, c), generator=generator, device=x.device)
    mask = (u < keep).permute(0, 3, 1, 2)
    scale = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class Dropout(nn.Module):
    """``flax.linen.Dropout``: the identity when not training or at rate
    0; else ``dropout`` with this site's generator from the forward's
    ``DropoutKeys``.  ``site`` is set by the model that owns the module
    (``RetinaNet`` numbers its dropouts in module order)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.site = 0

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        if not training or self.rate == 0.0:
            return x
        if keys is None:
            raise ValueError("dropout while training needs DropoutKeys: "
                             "pass the step's generator to the model")
        return dropout(x, self.rate, keys.generator(self.site, x.device))


class ConvGN(nn.Module):
    """conv (no bias) → GroupNorm → optional activation → optional
    dropout."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, gn_groups: int = 32,
                 activation: Optional[str] = None,
                 kernel_init: str = "he_normal", quantize: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel_size, strides,
                           kernel_init=kernel_init, quantize=quantize)
        self.GroupNorm_0 = GroupNorm(features, gn_groups,
                                     activation=activation)
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        y = self.GroupNorm_0(self.Conv_0(x))
        return y if self.dropout is None else self.dropout(y, training, keys)


def max_pool_same(x: Tensor, window: int, strides: int) -> Tensor:
    """Max pool with TF "SAME" padding by −inf (the stem's 3×3/2 pool pads
    0 before and 1 after on an even side)."""
    top, bottom = same_padding(x.shape[2], window, strides)
    left, right = same_padding(x.shape[3], window, strides)
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, window, strides)


def avg_pool_same(x: Tensor, window: int, strides: int) -> Tensor:
    """flax's ``avg_pool`` with "SAME" padding: the padding is zeros and
    counts in the mean (``count_include_pad``), which shows on odd
    sides."""
    top, bottom = same_padding(x.shape[2], window, strides)
    left, right = same_padding(x.shape[3], window, strides)
    return F.avg_pool2d(F.pad(x, (left, right, top, bottom)), window,
                        strides)


def nearest_upsample(x: Tensor, target_hw: Sequence[int]) -> Tensor:
    """Nearest resize with half-pixel centres, as ``jax.image.resize(...,
    "nearest")``; at exactly 2× this is a repeat of every pixel."""
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
