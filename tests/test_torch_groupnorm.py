"""The port's fused GroupNorm + activation (``ops/groupnorm.py``, the
plain version of kernel B4 on the CPU) against the JAX Pallas op in
interpret mode, forward and backward, at ``tests/test_pallas_groupnorm.py``'s
cases and bounds; and ``GroupNorm(use_kernel=True)`` off the card."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retinanet_tpu.ops.pallas.groupnorm import (_fused_forward,
                                                fused_group_norm_act as
                                                jax_gn_act)
from retinanet_tpu_torch.models.layers import (GroupNorm, group_norm,
                                               resolve_groups)
from retinanet_tpu_torch.ops.groupnorm import (fused_group_norm_act,
                                               fused_group_norm_act_plain)

torch.set_num_threads(2)

CASES = [
    # (shape, groups, activation), as test_pallas_groupnorm.py
    ((2, 8, 8, 256), 32, "elu"),
    ((1, 16, 8, 128), 32, "relu"),
    ((3, 5, 5, 64), 32, None),
    ((2, 10, 4, 96), 32, "elu"),
    ((1, 7, 3, 8), 8, "relu"),
    # the two forms the TPU kernel spells out that the cases above miss
    ((2, 6, 6, 64), 16, "swish"),
    ((2, 6, 6, 64), 16, "gelu"),
]


@pytest.mark.parametrize("shape,groups,act", CASES)
def test_forward_matches_jax_kernel(shape, groups, act):
    """fp32: ≤ 1e-5 (the same fp32 arithmetic, sums in another order)."""
    rng = np.random.RandomState(0)
    c = shape[-1]
    g = resolve_groups(c, groups)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    want = np.asarray(_fused_forward(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), g, 1e-5, act,
                                     interpret=True))
    got = fused_group_norm_act(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), g, 1e-5, act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert fused_group_norm_act.launches == 0


def test_forward_bf16():
    """bf16 in and out, fp32 affine: 2e-2, as the JAX test."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 256).astype(ml_dtypes.bfloat16)
    gamma = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    beta = rng.randn(256).astype(np.float32)
    want = np.asarray(_fused_forward(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), 32, 1e-5, "elu",
                                     interpret=True), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = fused_group_norm_act(xt, torch.from_numpy(gamma),
                               torch.from_numpy(beta), 32, 1e-5, "elu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("act", [None, "relu", "elu", "gelu"])
def test_backward_matches_jax(act):
    """dx, dγ, dβ against JAX ``fused_group_norm_act``'s custom VJP: 1e-4.
    gelu takes the generic branch (autograd of the activation)."""
    rng = np.random.RandomState(2)
    shape, g = (2, 6, 6, 64), 16
    x = rng.randn(*shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    beta = rng.randn(64).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)

    def loss(x, gamma, beta):
        return jnp.sum(jax_gn_act(x, gamma, beta, g, 1e-5, act, True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x),
                                             jnp.asarray(gamma),
                                             jnp.asarray(beta))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, gamma, beta)]
    out = fused_group_norm_act(*leaves, g, 1e-5, act)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for w, gg, name in zip(want, got, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_module_takes_group_norm_off_the_card():
    """``GroupNorm(use_kernel=True)`` on a CPU tensor above the 2¹⁸ gate
    equals ``group_norm`` bitwise (the JAX module's jnp path off the TPU),
    and the plain B4 differs from it only in where bf16 rounds."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 64, 64, 64).astype(np.float32)).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    mod = GroupNorm(64, activation="elu", use_kernel=True)
    with torch.no_grad():
        mod.gamma.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64)))
        mod.beta.copy_(torch.from_numpy(rng.randn(64)))
        got = mod(x)
        want = group_norm(x, mod.gamma, mod.beta, 32, 1e-5, "elu")
        fused = fused_group_norm_act_plain(x.permute(0, 2, 3, 1), mod.gamma,
                                           mod.beta, 32, 1e-5, "elu")
    assert 64 * 64 * 64 >= 1 << 18
    assert torch.equal(got, want)
    np.testing.assert_allclose(fused.float().numpy(),
                               want.permute(0, 2, 3, 1).float().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert fused_group_norm_act.launches == 0


def test_model_wide_switch_changes_nothing_off_the_card():
    """``use_group_norm_kernel`` sets ``use_kernel`` on every GroupNorm of
    a model (the stem, 4 per projection block, 3 per identity block, the
    FPN's and the 8 head GNs) and back; on CPU tensors the switched model
    gives the same heads bitwise (every GroupNorm still takes
    ``group_norm``) and launches nothing."""
    from retinanet_tpu_torch.config import Config, ModelConfig
    from retinanet_tpu_torch.export import init_params
    from retinanet_tpu_torch.models.layers import use_group_norm_kernel
    from retinanet_tpu_torch.models.retinanet import RetinaNet

    config = Config(model=ModelConfig(backbone="resnet_50_dense",
                                      num_classes=4, compute_dtype="float32"))
    model = RetinaNet.from_config(config.model, 9, 4).eval()
    model.load_state_dict(init_params(config, torch.Generator().manual_seed(0),
                                      4))
    mods = [m for m in model.modules() if isinstance(m, GroupNorm)]
    images = torch.from_numpy(
        np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        want = model(images)
        assert use_group_norm_kernel(model) == len(mods) > 60
        assert all(m.use_kernel for m in mods)
        got = model(images)
    assert use_group_norm_kernel(model, False) == len(mods)
    assert not any(m.use_kernel for m in mods)
    for head in want:
        for level in want[head]:
            assert torch.equal(got[head][level], want[head][level])
    assert fused_group_norm_act.launches == 0


def test_kernel_path_rule():
    """B4's fixed path rule on the shape (``kernel_path``): the cluster path
    only where a CTA's slice fits three to an SM and the batch fills at
    most one wave of clusters, as measured on the H100: P4 (40x40x256
    bf16) at batch 8; the split path at batch 128, for P3, the stem, and
    fp32 P4 (twice the bytes)."""
    from retinanet_tpu_torch.ops.groupnorm import (CLUSTER_FAST_SMEM,
                                                   cluster_smem, kernel_path)

    bf16, f32 = torch.bfloat16, torch.float32
    assert cluster_smem(40 * 40, 256, 32, 2) <= CLUSTER_FAST_SMEM
    assert kernel_path(8, 40 * 40, 256, 32, bf16) == "cluster"
    assert kernel_path(128, 40 * 40, 256, 32, bf16) == "split"
    assert kernel_path(8, 80 * 80, 256, 32, bf16) == "split"
    assert kernel_path(8, 320 * 320, 64, 32, bf16) == "split"
    assert kernel_path(8, 40 * 40, 256, 32, f32) == "split"
