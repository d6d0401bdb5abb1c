"""The port's fused stem epilogue (``ops/stem.py``: ``gn_relu_maxpool``, the
plain version of kernel B7 on the CPU, and ``fused_stem``) against the JAX
Pallas kernels in interpret mode, at ``tests/test_pallas_stem.py``'s shapes
and bounds, and against the port's own stem layers."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retinanet_tpu.ops.pallas.stem import fused_stem as jax_fused_stem
from retinanet_tpu.ops.pallas.stem import gn_relu_maxpool as jax_pool
from retinanet_tpu_torch.models.layers import ConvGN, max_pool_same
from retinanet_tpu_torch.ops.stem import fused_stem, gn_relu_maxpool

torch.set_num_threads(2)


@pytest.mark.parametrize("h,w", [(20, 16), (9, 7)])
def test_gn_relu_maxpool_matches_jax_kernel(h, w):
    """Bitwise: the same bf16 roundings and no sum.  The JAX kernel takes
    even sides only; an odd side is held to the port's own plain path
    (bf16 affine + relu, then ``max_pool_same`` with its 1/1 pads)."""
    rng = np.random.RandomState(0)
    y = rng.randn(2, h, w, 8).astype(ml_dtypes.bfloat16)
    scale = (rng.rand(2, 8) + 0.5).astype(np.float32)
    shift = (rng.randn(2, 8) * 0.1).astype(np.float32)
    yt = torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16)
    got = gn_relu_maxpool(yt, torch.from_numpy(scale),
                          torch.from_numpy(shift))
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, -(-h // 2), -(-w // 2), 8)
    assert gn_relu_maxpool.launches == 0
    if h % 2 == 0 and w % 2 == 0:
        want = jax_pool(jnp.asarray(y), jnp.asarray(scale),
                        jnp.asarray(shift), strip_rows=4, interpret=True)
    else:
        bf = ml_dtypes.bfloat16
        z = np.maximum(y * scale[:, None, None].astype(bf)
                       + shift[:, None, None].astype(bf), 0)
        want = jax.lax.reduce_window(
            jnp.asarray(z), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
            (1, 2, 2, 1), "SAME")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_fused_stem_matches_jax_kernel():
    """Conv + GN statistics + B7 against JAX ``fused_stem(interpret=True)``:
    2e-2 and ≥ 98% bitwise, as ``test_pallas_stem.py`` holds JAX's to the
    flax path (the two convs sum in another fp32 order before rounding to
    bf16).  Against the port's ``ConvGN(relu)`` + ``max_pool_same`` on the
    same weights it is bitwise equal."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, 3).astype(ml_dtypes.bfloat16)
    w = (rng.randn(7, 7, 3, 16) * np.sqrt(2.0 / 147)).astype(np.float32)
    gamma = (1 + rng.randn(16) * 0.05).astype(np.float32)
    beta = (rng.randn(16) * 0.05).astype(np.float32)
    want = np.asarray(jax_fused_stem(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(gamma), jnp.asarray(beta),
                                     interpret=True), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    wt, gt, bt = map(torch.from_numpy, (w, gamma, beta))
    got = fused_stem(xt, wt, gt, bt)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g = got.float().numpy()
    np.testing.assert_allclose(g, want, rtol=2e-2, atol=2e-2)
    assert (g == want).mean() > 0.98

    stem = ConvGN(3, 16, kernel_size=7, strides=2, activation="relu")
    with torch.no_grad():
        stem.Conv_0.kernel.copy_(wt.permute(3, 2, 0, 1))
        stem.GroupNorm_0.gamma.copy_(gt)
        stem.GroupNorm_0.beta.copy_(bt)
        ref = max_pool_same(stem(xt.permute(0, 3, 1, 2)), 3, 2)
    assert torch.equal(got, ref.permute(0, 2, 3, 1))
