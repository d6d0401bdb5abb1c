"""Port layers (retinanet_tpu_torch.models.layers) and the plain fused
bottleneck against the JAX package on the CPU, on numpy-seeded inputs.

Tolerances: fp32 ≤1e-5 (the same math, summed in another order); bf16
≤2⁻⁸ relative, at most one bf16 step (bf16 keeps 8 significant bits),
with 2⁻⁸ absolute near 0, since the two frameworks round the conv
accumulators to bf16 from differently ordered fp32 sums.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.models import layers as jl
from retinanet_tpu.models.resnet import ResNetBottleneck
from retinanet_tpu.ops.pallas.bottleneck import fused_bottleneck as jax_fused
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models import layers as tl
from retinanet_tpu_torch.ops.bottleneck import (fused_bottleneck,
                                                fused_bottleneck_plain)

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -8


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy → NCHW channels_last torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _randomize(params, seed):
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    for k, v in flat.items():
        if k.endswith("gamma"):
            flat[k] = 1.0 + 0.3 * rng.randn(*v.shape)
        elif k.endswith("beta"):
            flat[k] = 0.3 * rng.randn(*v.shape)
        else:
            flat[k] = rng.randn(*v.shape) * np.sqrt(2.0 / np.prod(v.shape[:-1]))
        flat[k] = flat[k].astype(np.float32)
    return flat


def _load(module, flat):
    module.load_state_dict(params_from_flax(flat))
    return module


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=BF16_STEP)


@pytest.mark.parametrize("act", [None, "relu", "elu", "gelu"])
def test_group_norm_fp32(act):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 64) * 3 + 1).astype(np.float32)
    mod = jl.GroupNorm(activation=act, dtype=jnp.float32)
    flat = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 1)
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, x))
    got = _load(tl.GroupNorm(64, activation=act), flat)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_group_norm_bf16():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 6, 5, 48) * 3).astype(ml_dtypes.bfloat16)
    mod = jl.GroupNorm(activation="relu", dtype=jnp.bfloat16)
    flat = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 3)
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")},
        jnp.asarray(x)), np.float32)
    got = _load(tl.GroupNorm(48, activation="relu"), flat)(
        _nchw(x.astype(np.float32), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close_bf16(_nhwc(got), want)


@pytest.mark.parametrize("k,s,hw", [(3, 2, (16, 16)), (7, 2, (18, 14)),
                                    (3, 1, (9, 7)), (1, 1, (5, 5)),
                                    (3, 2, (9, 7))])
def test_conv_gn_same_padding_fp32(k, s, hw):
    """ConvGN incl. the asymmetric stride-2 SAME pads (7×7/2 pads 2/3 on an
    even side, 3×3/2 pads 0/1)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, *hw, 8).astype(np.float32)
    mod = jl.ConvGN(16, kernel_size=k, strides=s, activation="relu",
                    dtype=jnp.float32)
    flat = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 5)
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, x))
    got = _load(tl.ConvGN(8, 16, k, s, activation="relu"), flat)(_nchw(x))
    assert _nhwc(got).shape == want.shape
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_conv_gn_bf16():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 12, 32).astype(ml_dtypes.bfloat16)
    mod = jl.ConvGN(32, kernel_size=3, strides=2, activation="relu")
    flat = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 7)
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")},
        jnp.asarray(x)), np.float32)
    got = _load(tl.ConvGN(32, 32, 3, 2, activation="relu"), flat)(
        _nchw(x.astype(np.float32), torch.bfloat16))
    _close_bf16(_nhwc(got), want)


def test_conv_bias_fp32():
    rng = np.random.RandomState(8)
    x = rng.randn(1, 7, 6, 16).astype(np.float32)
    mod = jl.Conv(12, kernel_size=3, use_bias=True, dtype=jnp.float32)
    flat = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 9)
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, x))
    got = _load(tl.Conv(16, 12, 3, use_bias=True), flat)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (9, 7)])
def test_max_pool_same(hw):
    rng = np.random.RandomState(10)
    x = rng.randn(2, *hw, 4).astype(np.float32) - 3  # negatives at the pads
    want = np.asarray(jl.max_pool_same(jnp.asarray(x), 3, 2))
    got = _nhwc(tl.max_pool_same(_nchw(x), 3, 2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((4, 6), (8, 12)), ((5, 5), (9, 9))])
def test_nearest_upsample(src, dst):
    rng = np.random.RandomState(11)
    x = rng.randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jl.nearest_upsample(jnp.asarray(x), dst))
    got = _nhwc(tl.nearest_upsample(_nchw(x), dst))
    np.testing.assert_array_equal(got, want)


def test_plain_bottleneck_matches_jax_kernel():
    """Plain fused_bottleneck (the CPU path of the wrapper) against the
    Pallas kernel in interpret mode at the shape of
    ``tests/test_pallas_bottleneck.py``: [2,16,12,64], F=16."""
    rng = np.random.RandomState(0)
    b, h, w, f = 2, 16, 12, 16
    x = rng.randn(b, h, w, 4 * f).astype(ml_dtypes.bfloat16)
    block = ResNetBottleneck(filters=f, project=False)
    flat = _randomize(block.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 training=False)["params"], 1)
    args = []
    for i in range(3):
        args += [flat[f"ConvGN_{i}/Conv_0/kernel"],
                 flat[f"ConvGN_{i}/GroupNorm_0/gamma"],
                 flat[f"ConvGN_{i}/GroupNorm_0/beta"]]
    want = np.asarray(jax_fused(jnp.asarray(x), *args, interpret=True),
                      np.float32)
    sd = params_from_flax(flat)
    targs = []
    for i in range(3):
        targs += [sd[f"ConvGN_{i}.Conv_0.kernel"],
                  sd[f"ConvGN_{i}.GroupNorm_0.gamma"],
                  sd[f"ConvGN_{i}.GroupNorm_0.beta"]]
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = fused_bottleneck(xt, *targs)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert torch.equal(got, fused_bottleneck_plain(xt, *targs))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert (got == want).mean() > 0.98
