"""The port's fused projection block (``fused_bottleneck_proj``, the plain
version of kernel B5 on the CPU) against the JAX Pallas kernel in
interpret mode and against the port's unfused block, and the gate that
sends a block to B5."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.models.resnet import ResNetBottleneck as JaxBottleneck
from retinanet_tpu.ops.pallas.bottleneck import \
    fused_bottleneck_proj as jax_proj
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models import resnet
from retinanet_tpu_torch.ops.bottleneck import (fused_bottleneck_proj,
                                                fused_bottleneck_proj_plain)

torch.set_num_threads(2)

B, H, W, CIN, F = 2, 16, 12, 32, 16


def _params(seed):
    """Flat flax parameters of a stride-1 projection block, He kernels and
    randomized GN γ/β."""
    block = JaxBottleneck(filters=F, project=True)
    shapes = jax.eval_shape(lambda: block.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, CIN), jnp.bfloat16),
        training=False))["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith("kernel"):
            a = rng.randn(*v.shape) * np.sqrt(2.0 / np.prod(v.shape[:-1]))
        else:
            a = (k.endswith("gamma")) + 0.3 * rng.randn(*v.shape)
        flat[k] = a.astype(np.float32)
    return flat


def _args(params, order):
    """(kernel, γ, β) of each ConvGN in ``order``, in the port's layout."""
    out = []
    for i in order:
        out += [params[f"ConvGN_{i}.Conv_0.kernel"],
                params[f"ConvGN_{i}.GroupNorm_0.gamma"],
                params[f"ConvGN_{i}.GroupNorm_0.beta"]]
    return out


def test_plain_proj_matches_jax_kernel():
    """Plain B5 against ``fused_bottleneck_proj(interpret=True,
    strip_rows=0)`` in bf16 at [2,16,12,32] → 64, F=16: the bound of the
    identity block's test (2e-2, ≥ 98% bitwise), since the two sum each
    conv in another fp32 order before rounding it to bf16.  The CPU
    wrapper takes the plain version and launches nothing."""
    flat = _params(0)
    x = np.random.RandomState(1).randn(B, H, W, CIN).astype(
        ml_dtypes.bfloat16)
    jargs = []
    for i in (1, 2, 3, 0):
        jargs += [flat[f"ConvGN_{i}/Conv_0/kernel"],
                  flat[f"ConvGN_{i}/GroupNorm_0/gamma"],
                  flat[f"ConvGN_{i}/GroupNorm_0/beta"]]
    want = np.asarray(jax_proj(jnp.asarray(x), *jargs, interpret=True,
                               strip_rows=0), np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    targs = _args(params_from_flax(flat), (1, 2, 3, 0))
    got = fused_bottleneck_proj(xt, *targs)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, 4 * F)
    assert torch.equal(got, fused_bottleneck_proj_plain(xt, *targs))
    assert fused_bottleneck_proj.launches == 0
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert (got == want).mean() > 0.98


def test_fused_proj_block_equals_unfused():
    """``ResNetBottleneck(project=True, fused_proj=True)`` at serving time
    runs B5's plain version on the CPU, and that is the unfused block's
    ops in the same order: bitwise equal."""
    state = params_from_flax(_params(2))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        B, CIN, H, W).astype(np.float32)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    fused = resnet.ResNetBottleneck(CIN, F, True, fused_proj=True)
    plain = resnet.ResNetBottleneck(CIN, F, True)
    for block in (fused, plain):
        block.load_state_dict(state)
    with torch.inference_mode():
        assert torch.equal(fused(x), plain(x))


# (project, dtype, quantize, training) → whether the block takes B5.
GATE = [
    (True, torch.bfloat16, False, False, True),
    ("down", torch.bfloat16, False, False, False),
    (True, torch.bfloat16, False, True, False),
    (True, torch.bfloat16, True, False, False),
    (True, torch.float32, False, False, False),
]


@pytest.mark.parametrize("project,dtype,quantize,training,takes", GATE)
def test_proj_gate(monkeypatch, project, dtype, quantize, training, takes):
    """B5 serves only the stride-1 projection block in bf16, never a down
    block, a training step or the int8 path (``resnet.py:143-144``)."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return fused_bottleneck_proj(*args, **kwargs)

    monkeypatch.setattr(resnet, "fused_bottleneck_proj", counting)
    block = resnet.ResNetBottleneck(64, 16, project, fused=True,
                                    fused_train=True, fused_proj=True,
                                    quantize=quantize)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("kernel"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(1, 64, 8, 8, generator=gen)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = block(x, training)
    assert out.shape[1] == 64 and bool(torch.isfinite(out.float()).all())
    assert len(calls) == int(takes)


@pytest.mark.parametrize("training", [False, True])
def test_int8_keeps_identity_blocks_off_b1_b3(monkeypatch, training):
    """Under ``quantize`` an identity block takes neither B1 nor B3, even
    with ``fused_blocks`` and ``fused_train`` on (``resnet.py:137``)."""
    calls = []
    for name in ("fused_bottleneck", "fused_bottleneck_train"):
        monkeypatch.setattr(resnet, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    block = resnet.ResNetBottleneck(64, 16, False, fused=True,
                                    fused_train=True, quantize=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("kernel"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        x = torch.randn(1, 64, 8, 8, generator=gen).to(torch.bfloat16)
        out = block(x.contiguous(memory_format=torch.channels_last), training)
    assert out.shape == x.shape and not calls
