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
from retinanet_tpu_torch.models.resnet import ResNetBottleneck
from retinanet_tpu_torch.ops.int8_conv import (int8_conv, int8_conv3x3,
                                               int8_conv_plain)

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hw", [(16, 12), (9, 7)])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_int8_conv_matches_jax(k, s, hw, dtype):
    """Every window and stride of the model path, even and odd sides (TF
    SAME pads stride 2 asymmetrically), output in x's dtype: bitwise."""
    rng = np.random.RandomState(k * 10 + s)
    x = (rng.randn(2, *hw, 16) * 2).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    kern = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)
    want = np.asarray(_int8_conv(jnp.asarray(x), jnp.asarray(kern), (s, s),
                                 "SAME", 1, getattr(jnp, dtype)), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    got = int8_conv(xt, torch.from_numpy(kern).permute(3, 2, 0, 1), s)
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
