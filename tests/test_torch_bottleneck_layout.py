"""The bf16 weight layouts that kernels B1 and B5 read
(``ops/bottleneck.py:prepare_weights``, ``prepare_proj_weights``), as
``ResNetBottleneck`` keeps them per parameter version, against the layouts
a wrapper call makes itself; and B1's ``return_forward`` on the CPU.  No
card: the layouts and the cache are plain PyTorch."""

import numpy as np
import pytest
import torch

from retinanet_tpu_torch.models.resnet import ResNetBottleneck
from retinanet_tpu_torch.ops import bottleneck as b1
from retinanet_tpu_torch.ops.bottleneck_bwd import recompute_forward

torch.set_num_threads(2)

CIN, FILTERS, SIDE = 32, 16, 6
KINDS = {
    # (block, its input channels, the layout function, its kernels' order)
    "identity": (lambda: ResNetBottleneck(4 * FILTERS, FILTERS, False,
                                          fused=True),
                 4 * FILTERS, b1.prepare_weights, (0, 1, 2)),
    "proj": (lambda: ResNetBottleneck(CIN, FILTERS, True, fused_proj=True),
             CIN, b1.prepare_proj_weights, (1, 2, 3, 0)),
}


def _block(kind: str, seed: int):
    make, cin, _, _ = KINDS[kind]
    block = make()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in block.named_parameters():
            noise = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
            p.copy_(0.2 * noise + name.endswith("gamma"))
    x = torch.from_numpy(rng.randn(2, cin, SIDE, SIDE).astype(np.float32))
    return block, x.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def _kernels(kind: str, block):
    return [getattr(block, f"ConvGN_{i}").Conv_0.kernel
            for i in KINDS[kind][3]]


def _per_call(kind: str, block):
    with torch.no_grad():
        return KINDS[kind][2](*_kernels(kind, block))


def _equal(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cached_layouts_equal_the_per_call_layouts(kind):
    """After a serving forward the block holds bitwise the layouts a call
    without ``weights`` makes: w1 (B5: the stacked [w1; wp]) [N, Cin], w2
    tap-major [F, 9F] and w3 [C, F], bf16 and contiguous; each element is
    its OIHW kernel's, rounded to bf16."""
    block, x = _block(kind, 1)
    with torch.no_grad():
        block(x)
    cached = block._fused_weights(*_kernels(kind, block))
    want = _per_call(kind, block)
    assert _equal(cached, want)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in cached)
    ks = [k.detach().to(torch.bfloat16) for k in _kernels(kind, block)]
    f = FILTERS
    first = torch.cat([k.reshape(k.shape[0], -1) for k in
                       ([ks[0], ks[3]] if kind == "proj" else [ks[0]])])
    assert torch.equal(cached[0], first)
    w2 = cached[1].view(f, 3, 3, f)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(w2[:, dy, dx, :], ks[1][:, :, dy, dx])
    assert torch.equal(cached[2], ks[2].reshape(4 * f, f))


@pytest.mark.parametrize("change", ["mul_", "load_state_dict"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_layouts_built_once_per_parameter_version(kind, change):
    """Serving twice builds the layouts once; an in-place update (as the
    optimizer's step makes) or ``load_state_dict`` builds them again, and
    the block then holds the new kernels' layouts."""
    block, x = _block(kind, 2)
    build = KINDS[kind][2]
    before = build.builds
    with torch.no_grad():
        first = block(x)
        again = block(x)
    assert build.builds == before + 1
    assert torch.equal(first, again)
    old = block._fused_weights(*_kernels(kind, block))
    with torch.no_grad():
        if change == "mul_":
            for k in _kernels(kind, block):
                k.mul_(-0.5)
        else:
            block.load_state_dict(_block(kind, 3)[0].state_dict())
        block(x)
        block(x)
    assert build.builds == before + 2
    cached = block._fused_weights(*_kernels(kind, block))
    assert build.builds == before + 2
    assert not _equal(cached, old)
    assert _equal(cached, _per_call(kind, block))


def test_training_forward_renews_the_layouts_each_step():
    """``fused_train``: each training forward after an optimizer-style
    in-place update lays the weights out again (one build per step), and
    the output is the plain block's."""
    block = ResNetBottleneck(4 * FILTERS, FILTERS, False, fused_train=True)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(
                0.2 * rng.randn(*p.shape).astype(np.float32)) + 1.0)
    x = torch.from_numpy(rng.randn(1, 4 * FILTERS, SIDE, SIDE).astype(
        np.float32)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    before = b1.prepare_weights.builds
    for step in range(2):
        out = block(x, training=True)
        out.float().sum().backward()
        with torch.no_grad():
            for p in block.parameters():
                p.add_(-1e-3 * p.grad)
                p.grad = None
        assert b1.prepare_weights.builds == before + step + 1
    params = []
    for i in range(3):
        conv = getattr(block, f"ConvGN_{i}")
        params += [conv.Conv_0.kernel, conv.GroupNorm_0.gamma,
                   conv.GroupNorm_0.beta]
    with torch.no_grad():
        want = b1.fused_bottleneck_plain(x.permute(0, 2, 3, 1), *params)
        got = block(x, training=True).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


def test_cpu_return_forward_is_the_plain_recompute():
    """On CPU tensors ``fused_bottleneck(..., return_forward=True)`` is the
    plain block and the plain ``recompute_forward``, and launches
    nothing."""
    block, x = _block("identity", 5)
    params = []
    for i in range(3):
        conv = getattr(block, f"ConvGN_{i}")
        params += [conv.Conv_0.kernel.detach(), conv.GroupNorm_0.gamma.detach(),
                   conv.GroupNorm_0.beta.detach()]
    xn = x.permute(0, 2, 3, 1).contiguous()
    launches = b1.fused_bottleneck.launches
    out, fwd = b1.fused_bottleneck(xn, *params, return_forward=True)
    assert torch.equal(out, b1.fused_bottleneck_plain(xn, *params))
    want = recompute_forward(xn, *params)
    assert _equal(fwd[:3], want[:3])
    assert all(_equal(a, b) for a, b in zip(fwd[3], want[3]))
    assert b1.fused_bottleneck.launches == launches
