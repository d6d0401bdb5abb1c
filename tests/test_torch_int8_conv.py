"""The port's int8 convolution (``retinanet_tpu_torch/ops/int8_conv.py``,
the plain version of kernel B6 on the CPU) and its int8 blocks against the
JAX package's ``_int8_conv``, ``int8_conv3x3`` (Pallas, interpret mode) and
``ResNetBottleneck(quantize=True)`` on numpy-seeded inputs.

Quantization is the same function in both (division by the per-tensor
scale, round half to even, per-output-channel weight scales) and the
integer sums are exact, so ``int8_conv`` is expected bitwise.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.models.layers import _int8_conv
from retinanet_tpu.models.resnet import ResNetBottleneck as JaxBottleneck
from retinanet_tpu.ops.pallas.int8_conv import int8_conv3x3 as jax_conv3x3
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.layers import Conv
from retinanet_tpu_torch.models.resnet import ResNetBottleneck
from retinanet_tpu_torch.ops.int8_conv import (int8_conv, int8_conv3x3,
                                               int8_conv_plain,
                                               prepare_weights,
                                               quantize_activations,
                                               quantize_weights)

torch.set_num_threads(2)


def activation_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain counterpart of ``int8_amax``'s arithmetic: the largest |x|
    (exact in any order), then max(·, 1e-8) / 127 in fp32 with a true
    division."""
    amax = x.float().abs().amax()
    return (torch.maximum(amax, torch.full_like(amax, 1e-8))
            / torch.full_like(amax, 127.0))


@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hw", [(16, 12), (9, 7)])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_int8_conv_matches_jax(k, s, hw, dtype, prepared):
    """Every window and stride of the model path, even and odd sides (TF
    SAME pads stride 2 asymmetrically), output in x's dtype: bitwise,
    with the weights quantized in the call or prepared once (the tap-major
    layout the GEMM reads)."""
    rng = np.random.RandomState(k * 10 + s)
    x = (rng.randn(2, *hw, 16) * 2).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    kern = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)
    want = np.asarray(_int8_conv(jnp.asarray(x), jnp.asarray(kern), (s, s),
                                 "SAME", 1, getattr(jnp, dtype)), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    kernel = torch.from_numpy(kern).permute(3, 2, 0, 1)
    weights = prepare_weights(kernel) if prepared else None
    got = int8_conv(xt, kernel, s, weights=weights)
    assert got.dtype == xt.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert int8_conv.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("bias_relu", [False, True])
def test_int8_conv3x3_matches_jax_kernel(bias_relu):
    """The JAX entry point's signature against the Pallas kernel in
    interpret mode, at ``tests/test_pallas_int8_conv.py``'s bounds (2e-2,
    ≥ 97% equal): the TPU kernel quantizes by multiplying with 1/s_x and
    the port divides, as the model path does, so a few inputs land on the
    other integer."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 9, 8).astype(ml_dtypes.bfloat16)
    w = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    bias = rng.randn(16).astype(np.float32) if bias_relu else None
    want = np.asarray(jax_conv3x3(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), relu=bias_relu,
        strip_rows=5, interpret=True), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    bt = None if bias is None else torch.from_numpy(bias)
    got = int8_conv3x3(xt, torch.from_numpy(w), bt, relu=bias_relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert (got == want).mean() >= 0.97
    if bias_relu:
        assert (got >= 0).all()
    # The same function as the model path's plus the fp32 bias and relu.
    plain = int8_conv_plain(xt, torch.from_numpy(w).permute(3, 2, 0, 1), 1,
                            torch.bfloat16, bt, bias_relu)
    assert torch.equal(plain.float(), torch.from_numpy(got))


@pytest.mark.parametrize("project,cin,hw", [("down", 64, (16, 12)),
                                            (False, 64, (16, 12)),
                                            (True, 32, (9, 7))])
def test_int8_blocks_match_jax(project, cin, hw):
    """fp32 ``ResNetBottleneck(quantize=True)`` against JAX's on the same
    weights, for each block kind: ≤ 1e-5 (measured 1.4e-6: the GN sums'
    fp32 order), while the float block sits ~0.1 away, so the int8 path
    is really taken."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    jb = JaxBottleneck(filters=16, project=project, quantize=True,
                       dtype=jnp.float32)
    params = jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.asarray(x), training=False))["params"]
    flat = {k: (rng.randn(*v.shape) * (np.sqrt(2.0 / np.prod(v.shape[:-1]))
                                       if k.endswith("kernel") else 0.3)
                + (1.0 if k.endswith("gamma") else 0.0)).astype(np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    tree = traverse_util.unflatten_dict(flat, sep="/")
    want = np.asarray(jax.jit(jb.apply)({"params": tree}, jnp.asarray(x)))
    floats = np.asarray(jax.jit(JaxBottleneck(
        filters=16, project=project, dtype=jnp.float32).apply)(
        {"params": tree}, jnp.asarray(x)))
    block = ResNetBottleneck(cin, 16, project, quantize=True)
    block.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(floats - want).max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_device_scale_formula_matches_quantize_activations(dtype):
    """``int8_amax``'s arithmetic (the largest |x| by bit pattern, then
    max(·, 1e-8) / 127 with a true division), written plainly, equals
    ``quantize_activations`` bitwise, and both equal numpy's float32
    quotient: over 200 seeded tensors whose scales span 1e-12..1e4,
    negative-dominant ones, and all-zero ones (the 1e-8 floor)."""
    rng = np.random.RandomState(7)
    cases = [rng.randn(64, 8) * 10.0 ** rng.uniform(-12, 4)
             for _ in range(200)]
    cases += [-np.abs(rng.randn(3, 16)) * 37.0, np.zeros((4, 16))]
    for a in cases:
        x = torch.from_numpy(a.astype(np.float32)).to(dtype)
        want = quantize_activations(x)
        got = activation_scale_plain(x)
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want), (got.item(), want.item())
        amax = np.float32(np.abs(x.float().numpy()).max())
        exact = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
        assert want.item() == float(exact)


def _conv_and_input(seed: int):
    rng = np.random.RandomState(seed)
    conv = Conv(16, 32, kernel_size=3, strides=1, quantize=True)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(
            (rng.randn(32, 16, 3, 3) * 0.2).astype(np.float32)))
    x = torch.from_numpy(rng.randn(2, 16, 9, 7).astype(np.float32))
    return conv, x


def _plain_of(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    return int8_conv_plain(x.permute(0, 2, 3, 1), conv.kernel.detach(), 1,
                           x.dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("change", ["load_state_dict", "mul_", "to"])
def test_conv_keeps_weights_per_parameter_version(change):
    """``Conv(quantize=True)`` quantizes its kernel once and serves the
    prepared weights until the kernel changes: ``load_state_dict``, an
    in-place ``mul_`` and ``.to()`` (to bf16, which rounds the kernel,
    so stale weights would show) each rebuild them, and the output equals
    the plain version of the kernel as it now stands, bitwise."""
    conv, x = _conv_and_input(11)
    with torch.no_grad():
        first = conv(x)
        builds = prepare_weights.builds
        again = conv(x)
    assert prepare_weights.builds == builds  # served from the cache
    assert torch.equal(first, again) and torch.equal(first, _plain_of(conv, x))
    other, _ = _conv_and_input(12)
    with torch.no_grad():
        if change == "load_state_dict":
            conv.load_state_dict(other.state_dict())
        elif change == "mul_":
            conv.kernel.mul_(-0.5)
        else:
            conv.to(torch.bfloat16)
            x = x.to(torch.bfloat16)
        got = conv(x)
    assert prepare_weights.builds == builds + 1
    assert not torch.equal(got.float(), first.float())
    assert torch.equal(got, _plain_of(conv, x))


def _quantize_by_reciprocal(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``int8_quantize``'s arithmetic in fp32: t = x · RN(1/s), the true
    division only where t lies within 1e-4 of a half-integer."""
    rs = torch.ones_like(s) / s
    t = x * rs
    near = (t - torch.floor(t) - 0.5).abs() < 1e-4
    t = torch.where(near, x / s, t)
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def test_quantize_by_reciprocal_equals_the_division():
    """The kernel multiplies by 1/s_x and divides only near a rounding
    boundary; that gives clip(round(x / s_x)) bitwise, here over 200
    seeded scales with inputs at, and within 1e-6..1e-3 of, every
    half-integer quotient in [-128, 128], ties included, and random
    inputs up to ±amax."""
    rng = np.random.RandomState(5)
    halves = np.arange(-128, 128) + 0.5
    for _ in range(200):
        amax = np.float32(10.0 ** rng.uniform(-6, 3))
        s = torch.tensor(max(amax, np.float32(1e-8))) / torch.tensor(
            np.float32(127.0))
        sv = np.float32(s.item())
        offsets = np.concatenate([[0.0], rng.choice([-1, 1], 64)
                                  * 10.0 ** rng.uniform(-6, -3, 64)])
        near = ((halves[:, None] + offsets[None, :]) * sv).astype(np.float32)
        spread = (rng.uniform(-1, 1, 4096) * amax).astype(np.float32)
        x = torch.from_numpy(np.concatenate([near.ravel(), spread]))
        want = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        assert torch.equal(_quantize_by_reciprocal(x, s), want)


def test_weight_scale_is_the_quotient():
    """``quantize_weights``' s_w divides the per-channel amax by a tensor
    (PyTorch's CUDA division by a Python scalar multiplies by its rounded
    reciprocal instead): bitwise ``amax / torch.full_like(amax, 127.0)``,
    and bitwise the JAX package's formula (``layers.py:253-254``) on a
    seeded kernel whose channel scales span 1e-14..1e3 (the 1e-12 floor
    included)."""
    rng = np.random.RandomState(13)
    o = 96
    kernel = (rng.randn(o, 8, 3, 3)
              * 10.0 ** rng.uniform(-14, 3, (o, 1, 1, 1))).astype(np.float32)
    w_q, s_w = quantize_weights(torch.from_numpy(kernel))
    amax = torch.clamp(torch.from_numpy(np.abs(kernel).max(axis=(1, 2, 3))),
                       min=1e-12)
    assert torch.equal(s_w, amax / torch.full_like(amax, 127.0))
    hwio = jnp.asarray(kernel.transpose(2, 3, 1, 0))
    want = jnp.maximum(jnp.max(jnp.abs(hwio), axis=(0, 1, 2)), 1e-12) / 127.0
    assert np.array_equal(s_w.numpy(), np.asarray(want))
    want_q = jnp.clip(jnp.round(hwio / want), -127, 127).astype(jnp.int8)
    assert np.array_equal(w_q.permute(2, 3, 1, 0).numpy(), np.asarray(want_q))
