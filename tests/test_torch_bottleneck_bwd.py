"""The port's fused bottleneck backward (``ops/bottleneck_bwd.py``, kernel
B3's plain version on the CPU) against the JAX package: its Pallas kernel
in interpret mode, ``jax.grad`` of the flax block, and the port's own
unfused block through autograd under ``fused_train``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.models.resnet import ResNetBottleneck as JaxBlock
from retinanet_tpu.ops.pallas.bottleneck_bwd import \
    fused_bottleneck_bwd as jax_bwd
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.resnet import ResNetBottleneck
from retinanet_tpu_torch.ops import bottleneck
from retinanet_tpu_torch.ops.bottleneck_bwd import (
    fused_bottleneck_bwd, fused_bottleneck_bwd_plain, fused_bottleneck_train,
    recompute_forward, relu_inputs)

torch.set_num_threads(2)

B, H, W, F = 2, 10, 8, 8
C = 4 * F
NAMES = ["dx"] + [f"{t}{i}" for i in (1, 2, 3) for t in ("k", "g", "b")]


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 and back to float32 (what both sides see)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def block():
    """Numpy-seeded x, dout and flax-layout parameters (He kernels, γ ≈ 1
    and β ≈ 0 with 0.3 noise), plus the JAX kernel's gradients at strip
    rows 10 (one strip: the whole image, as the plain version)."""
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(B, H, W, C))
    dout = _bf16(rng.randn(B, H, W, C))
    flat = {}
    for i, shape in enumerate(((1, 1, C, F), (3, 3, F, F), (1, 1, F, C))):
        fan_in = int(np.prod(shape[:-1]))
        n = shape[-1]
        flat[f"ConvGN_{i}/Conv_0/kernel"] = (
            rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        flat[f"ConvGN_{i}/GroupNorm_0/gamma"] = (
            1.0 + 0.3 * rng.randn(n)).astype(np.float32)
        flat[f"ConvGN_{i}/GroupNorm_0/beta"] = (
            0.3 * rng.randn(n)).astype(np.float32)
    packed = [flat[f"ConvGN_{i}/{leaf}"] for i in range(3)
              for leaf in ("Conv_0/kernel", "GroupNorm_0/gamma",
                           "GroupNorm_0/beta")]
    want = jax_bwd(jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(dout, jnp.bfloat16),
                   *map(jnp.asarray, packed), interpret=True, strip_rows=10)
    return x, dout, flat, [np.asarray(a, np.float32) for a in want]


def _port_args(x, dout, flat):
    state = params_from_flax(flat)
    params = [state[f"ConvGN_{i}.{leaf}"] for i in range(3)
              for leaf in ("Conv_0.kernel", "GroupNorm_0.gamma",
                           "GroupNorm_0.beta")]
    bf = torch.bfloat16
    return [torch.tensor(x).to(bf), torch.tensor(dout).to(bf), *params]


def _to_flax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy() if t.dtype == torch.float64 else \
        t.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if name.startswith("k") else a


def _close(ref, got, name, rel, corr_min):
    """Scale-relative max error and correlation (the JAX tests' measure)."""
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(ref / scale, got / scale, atol=rel,
                               err_msg=name)
    corr = np.corrcoef(ref.ravel(), got.ravel())[0, 1]
    assert corr > corr_min, (name, corr)


def test_plain_matches_jax_kernel(block):
    """The same seven passes and rounding points as the Pallas kernel:
    every output within 1e-5 of max|ref| (fp32 summation order only;
    measured dx exact, the largest gap 2.4e-6 of max|dk3|)."""
    x, dout, flat, want = block
    got = fused_bottleneck_bwd_plain(*_port_args(x, dout, flat))
    for name, w, g in zip(NAMES, want, got):
        g = _to_flax_layout(name, g).reshape(w.shape)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-5 * scale, name


@pytest.fixture(scope="module")
def autodiff(block):
    """``jax.grad`` of the flax ``ResNetBottleneck`` for the same
    cotangent, in the order of ``NAMES``."""
    x, dout, flat, _ = block
    jblock = JaxBlock(filters=F, project=False)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})

    def loss(xx, p):
        out = jblock.apply({"params": p}, xx, training=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout))

    dx, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16),
                                            params)
    dp = {"/".join(k): np.asarray(v) for k, v in
          traverse_util.flatten_dict(dp).items()}
    return [np.asarray(dx, np.float32)] + [
        dp[f"ConvGN_{i}/{leaf}"] for i in range(3)
        for leaf in ("Conv_0/kernel", "GroupNorm_0/gamma",
                     "GroupNorm_0/beta")]


def test_plain_matches_jax_autodiff(block, autodiff):
    """Against ``jax.grad`` at the JAX kernel test's bound (0.03 of
    max|ref|, correlation > 0.999): XLA autodiff reduces the GN
    cotangents in bf16, the plain version in fp32."""
    x, dout, flat, _ = block
    got = fused_bottleneck_bwd_plain(*_port_args(x, dout, flat))
    for name, w, g in zip(NAMES, autodiff, got):
        _close(w, _to_flax_layout(name, g).reshape(w.shape), name, 0.03,
               0.999)


def test_plain_as_accurate_as_autodiff_against_float64(block, autodiff):
    """``dtype=torch.float64`` rounds nowhere and gives the exact
    gradient.  Against it the bf16 plain version is at least as accurate
    as XLA autodiff: max error relative to max|truth| ≤ 1.2× autodiff's
    + 5e-3, the JAX package's own criterion for its kernel (the same one
    ``chip_smoke.py`` applies to B3 on the card)."""
    x, dout, flat, _ = block
    args = _port_args(x, dout, flat)
    truth = fused_bottleneck_bwd_plain(*args, dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in truth)
    got = fused_bottleneck_bwd_plain(*args)
    for name, t, g, w in zip(NAMES, truth, got, autodiff):
        t = _to_flax_layout(name, t.double()).reshape(w.shape)
        g = _to_flax_layout(name, g).reshape(w.shape)
        scale = np.abs(t).max()
        err_plain = np.abs(g - t).max() / scale
        err_xla = np.abs(w - t).max() / scale
        assert err_plain <= 1.2 * err_xla + 5e-3, (name, err_plain, err_xla)


def test_cpu_wrapper_runs_the_plain_version(block):
    """On CPU tensors the wrapper is the plain version, launches nothing,
    and the autograd Function returns its gradients."""
    x, dout, flat, _ = block
    xt, dt, *params = _port_args(x, dout, flat)
    before = fused_bottleneck_bwd.launches
    got = fused_bottleneck_bwd(xt, dt, *params)
    for a, b in zip(got, fused_bottleneck_bwd_plain(xt, dt, *params)):
        assert torch.equal(a, b)
    assert fused_bottleneck_bwd.launches == before
    assert bottleneck.fused_bottleneck.launches == 0

    xg = xt.clone().requires_grad_()
    leaves = [p.clone().requires_grad_() for p in params]
    out = fused_bottleneck_train(xg, *leaves)
    assert torch.equal(out, bottleneck.fused_bottleneck_plain(xt, *params))
    out.backward(dt)
    assert xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, got[0])
    for leaf, g in zip(leaves, got[1:]):
        assert leaf.grad.shape == leaf.shape and torch.equal(leaf.grad, g)


def test_plain_on_a_given_forward(block):
    """``forward=`` replaces the plain version's recompute: given its own
    ``recompute_forward`` the gradients are the same bit for bit, and the
    CPU wrapper's ``return_forward`` hands back that forward.  The third
    relu input is the block's pre-activation: its relu is the plain
    forward's output exactly.  Another forward changes the gradients."""
    x, dout, flat, _ = block
    xt, dt, *params = _port_args(x, dout, flat)
    fwd = recompute_forward(xt, *params)
    y1, y2, y3, stats = fwd
    assert [tuple(t.shape) for t in (y1, y2, y3)] == [
        (B, H * W, F), (B, H * W, F), (B, H * W, C)]
    assert all(t.dtype == torch.bfloat16 for t in (y1, y2, y3))
    assert [tuple(t.shape) for pair in stats for t in pair] == [
        (B, F)] * 4 + [(B, C)] * 2
    want = fused_bottleneck_bwd_plain(xt, dt, *params)
    for a, b in zip(want, fused_bottleneck_bwd_plain(xt, dt, *params,
                                                     forward=fwd)):
        assert torch.equal(a, b)
    grads, got_fwd = fused_bottleneck_bwd(xt, dt, *params,
                                          return_forward=True)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    for a, b in zip(got_fwd[:3], fwd[:3]):
        assert torch.equal(a, b)
    pre = relu_inputs(xt, fwd, *params[1:3], *params[4:6], *params[7:9])[2]
    assert torch.equal(torch.relu(pre).reshape(xt.shape),
                       bottleneck.fused_bottleneck_plain(xt, *params))
    moved = fused_bottleneck_bwd_plain(
        xt, dt, *params, forward=(y1, y2, -y3, stats))
    assert not torch.equal(moved[0], want[0])


def test_fused_train_module_path_matches_plain_block():
    """``fused_train=True``: the same parameter names, and under a
    sum-of-squares loss the same gradients as the port's unfused block
    through autograd (0.10 of max|ref|, correlation > 0.97: the bound of
    the JAX package's module-path test; the GN β/γ sums cancel heavily
    and autograd reduces them in bf16)."""
    rng = np.random.RandomState(1)
    plain = ResNetBottleneck(C, F, project=False)
    fused = ResNetBottleneck(C, F, project=False, fused_train=True)
    assert ([n for n, _ in plain.named_parameters()]
            == [n for n, _ in fused.named_parameters()])
    with torch.no_grad():
        for name, p in plain.named_parameters():
            noise = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
            if name.endswith("kernel"):
                p.copy_(noise * np.sqrt(2.0 / p[0].numel()))
            else:
                p.copy_(noise * 0.3 + (name.endswith("gamma")))
    fused.load_state_dict(plain.state_dict())
    x = torch.from_numpy(rng.randn(1, C, 8, 8).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def grads(block):
        xx = x.clone().requires_grad_()
        out = block(xx, training=True)
        (out.float() ** 2).sum().backward()
        return {"x": xx.grad, **{n: p.grad for n, p in
                                 block.named_parameters()}}

    want, got = grads(plain), grads(fused)
    assert set(want) == set(got)
    for name in want:
        _close(want[name].float().numpy(), got[name].float().numpy(), name,
               0.10, 0.97)
