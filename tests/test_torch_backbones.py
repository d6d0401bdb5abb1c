"""The backbones beside the dense flagship (``resnet_50`` = ResNeXt-50
32×4d, the default; ``mobilenet_v2``; ``densenet_121``/``densenet_169``),
their new layers, B6's plain version at their int8 shapes and dropout,
against the JAX package on the CPU, on numpy-seeded inputs (the FLOP
count, train steps and CLIs: ``test_torch_backbones_steps.py``).

Models run at 72 px, batch 2, 4 classes, so that DenseNet's transitions
pool an odd 9 → 5 and MobileNetV2 has odd stages.  DenseNet runs as
``DenseNetBC(blocks=(2, 2, 2, 2))`` (both packages take ``blocks``): the
test swaps it in for both packages' ``densenet_121`` factory, in this
process only.  Bounds:

* fp32: every C1..C5 tap and head within 1e-3·max(1, |ref|) (measured:
  ≤ 2.2e-4 on ResNeXt-50, ≤ 1.7e-5 on the others).
* bf16 and int8: each framework rounds at other places, and the error
  grows through every GroupNorm; ResNeXt-50's grouped-conv GroupNorm has
  one channel per group over 9 pixels at res5, which amplifies it most.
  So each head level is held to the distance that JAX's own model of that
  kind keeps from its float32 model: ‖port − jax‖₂ ≤ 1.25·‖jax −
  jax_fp32‖₂ (measured ratios ≤ 1.12), and the int8 heads also to the
  flagship's int8 bounds (‖Δ‖₂/‖ref‖₂ ≤ 0.25, correlation ≥ 0.98) where
  JAX's own int8 model stays within them of its float32 model.  Each int8
  block, fed JAX's own input, matches JAX's block to ‖Δ‖₂/‖ref‖₂ ≤ 1e-3,
  and most blocks to 1e-6: an fp32 ulp of a GroupNorm flips a quantized
  input now and then, and ResNeXt-50's per-channel GroupNorm spreads it
  over the channel (measured: 10 of 15 ResNeXt blocks ≤ 1.2e-7, the
  others 7e-6 to 7.1e-4; every MobileNetV2 and DenseNet block ≤ 1.3e-7).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.config import ModelConfig as JaxModelConfig
from retinanet_tpu.export import _leaf_path
from retinanet_tpu.models import layers as jl
from retinanet_tpu.models import retinanet as jret
from retinanet_tpu.models.densenet import DenseNetBC as JaxDenseNetBC
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.export import init_params, params_from_flax
from retinanet_tpu_torch.models import layers as tl
from retinanet_tpu_torch.models import retinanet as tret
from retinanet_tpu_torch.models.densenet import DenseNetBC
from retinanet_tpu_torch.ops import int8_conv as b6
from retinanet_tpu_torch.ops.grouped import block_diagonal

from torch_parity import random_flat_params, to_flax

torch.set_num_threads(2)

SIZE, BATCH, CLASSES = 72, 2, 4
LEVELS = ("P3", "P4", "P5", "P6", "P7")
HEADS = ("classifications", "regressions")
# Parity cases: "densenet" is densenet_121 at blocks (2, 2, 2, 2).
CASES = ("resnet_50", "mobilenet_v2", "densenet")
NOISE_RATIO = 1.25


@contextlib.contextmanager
def _backbone(case):
    """The backbone name of ``case``, with both packages' densenet_121
    factory swapped for blocks (2, 2, 2, 2) while it is open."""
    if case != "densenet":
        yield case
        return
    saved = jret.DenseNetBC121, tret.DenseNetBC121
    jret.DenseNetBC121 = lambda **kw: JaxDenseNetBC(blocks=(2, 2, 2, 2),
                                                    **kw)
    tret.DenseNetBC121 = lambda **kw: DenseNetBC(blocks=(2, 2, 2, 2), **kw)
    try:
        yield "densenet_121"
    finally:
        jret.DenseNetBC121, tret.DenseNetBC121 = saved


def _images(size=SIZE, seed=1):
    return np.random.RandomState(seed).randn(BATCH, size, size, 3).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _flat(case):
    with _backbone(case) as name:
        return random_flat_params(JaxModelConfig(
            backbone=name, num_classes=CLASSES, compute_dtype="float32"), 0)


@functools.lru_cache(maxsize=None)
def _run(case, dtype, quantize="none"):
    """(JAX taps, JAX heads, port taps, port heads), NHWC float32 numpy;
    for int8 also JAX's captured block inputs/outputs."""
    flat, images = _flat(case), _images()
    with _backbone(case) as name:
        jcfg = JaxModelConfig(backbone=name, num_classes=CLASSES,
                              compute_dtype=dtype, quantize=quantize)
        jmodel = jret.RetinaNet.from_config(jcfg, 9, CLASSES)

        def both(m, x):
            return m.backbone_net(x.astype(m.dtype), training=False), m(x)

        (jt, jh), inter = jax.jit(lambda p, x: jmodel.apply(
            {"params": p}, x, method=both, capture_intermediates=True,
            mutable=["intermediates"]))(to_flax(flat), jnp.asarray(images))
        model = tret.RetinaNet.from_config(tcfg.ModelConfig(
            backbone=name, num_classes=CLASSES, compute_dtype=dtype,
            quantize=quantize), 9, CLASSES)
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        x = torch.from_numpy(images)
        pt = model.backbone_net(x.to(model.dtype).permute(0, 3, 1, 2))
        ph = model(x)
    return ({k: np.asarray(v, np.float32) for k, v in jt.items()},
            {h: {pn: np.asarray(jh[h][pn], np.float32) for pn in LEVELS}
             for h in HEADS},
            {k: _np(v.permute(0, 2, 3, 1)) for k, v in pt.items()},
            {h: {pn: _np(ph[h][pn]) for pn in LEVELS} for h in HEADS},
            inter["intermediates"]["backbone_net"], model)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- layers ------------------------------------------------------------------


def _flax_params(mod, x, seed):
    params = mod.init(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    for k, v in flat.items():
        scale = np.sqrt(2.0 / np.prod(v.shape[:-1])) if k.endswith(
            "kernel") else 0.3
        base = 1.0 if k.endswith("gamma") else 0.0
        flat[k] = (base + scale * rng.randn(*v.shape)).astype(np.float32)
    return flat


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("form", ["grouped", "block_diagonal", "depthwise",
                                  "forced_true_grouped"])
def test_grouped_conv_matches_jax(form):
    """fp32 grouped convs ≤1e-5: cardinality 8 truly grouped (C ≠ F, so
    ``grouped_as_dense`` does not apply), block-diagonal dense (C = F),
    depthwise (groups = C, stride 2 on an odd side), and the dense form
    with ``force_true_grouped`` on in both packages.  The HWIO → OIHW
    transpose loads every grouped kernel unchanged."""
    rng = np.random.RandomState(3)
    c, f, g, s = {"grouped": (32, 64, 8, 1), "block_diagonal": (64, 64, 8, 2),
                  "depthwise": (24, 24, 24, 2),
                  "forced_true_grouped": (64, 64, 8, 1)}[form]
    x = rng.randn(2, 9, 7, c).astype(np.float32)
    dense = form in ("block_diagonal", "forced_true_grouped")
    mod = jl.Conv(f, kernel_size=3, strides=s, feature_group_count=g,
                  grouped_as_dense=dense, dtype=jnp.float32)
    flat = _flax_params(mod, x, 4)
    conv = tl.Conv(c, f, 3, s, feature_group_count=g, grouped_as_dense=dense)
    conv.load_state_dict(params_from_flax(flat))
    assert tuple(conv.kernel.shape) == (f, c // g, 3, 3)
    forced = form == "forced_true_grouped"
    ctx = ((jl.force_true_grouped(), tl.force_true_grouped()) if forced
           else (contextlib.nullcontext(), contextlib.nullcontext()))
    with ctx[0], ctx[1]:
        want = np.asarray(mod.apply(
            {"params": traverse_util.unflatten_dict(flat, sep="/")}, x))
        got = _np(conv(_nchw(x)).permute(0, 2, 3, 1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_avg_pool_same_counts_the_padding():
    """flax's SAME ``avg_pool`` divides by the window with the zero padding
    included: a 9×7 side pools to 5×4, the last row and column averaging
    one or two real values over 4."""
    x = np.random.RandomState(5).randn(2, 9, 7, 3).astype(np.float32) + 2
    want = np.asarray(jl.avg_pool_same(jnp.asarray(x), 2, 2))
    got = _np(tl.avg_pool_same(_nchw(x), 2, 2).permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 5, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.allclose(got[:, -1, -1], x[:, -1, -1] / 4)


def test_conv_gn_with_dropout_off_matches_jax():
    """``ConvGN(dropout_rate=0.2)`` when not training is conv → GN → act,
    as JAX's deterministic dropout; the dropout adds no parameter."""
    x = np.random.RandomState(6).randn(2, 10, 10, 16).astype(np.float32)
    mod = jl.ConvGN(24, kernel_size=1, activation="elu", dropout_rate=0.2,
                    dtype=jnp.float32)
    flat = _flax_params(mod, x, 7)
    conv = tl.ConvGN(16, 24, 1, activation="elu", dropout_rate=0.2)
    conv.load_state_dict(params_from_flax(flat))
    want = np.asarray(mod.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, x,
        training=False))
    got = _np(conv(_nchw(x), training=False).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- whole models ------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_backbone_fp32_matches_jax(case):
    """C1..C5 and every head level within 1e-3·max(1, |ref|)."""
    jt, jh, pt, ph = _run(case, "float32")[:4]
    assert set(pt) == set(jt) == {"C1", "C2", "C3", "C4", "C5"}
    pairs = [(k, pt[k], jt[k]) for k in jt] + [
        (h + pn, ph[h][pn], jh[h][pn]) for h in HEADS for pn in LEVELS]
    for name, got, want in pairs:
        assert got.shape == want.shape, name
        assert (np.abs(got - want) <= 1e-3 * np.maximum(1.0, np.abs(want))
                ).all(), (case, name, np.abs(got - want).max())


@pytest.mark.parametrize("case", CASES)
def test_backbone_bf16_matches_jax(case):
    """bf16 serving: each head level and C3..C5 no farther from JAX's bf16
    model than that model is from JAX's float32 one (times 1.25), and
    correlated above 0.95 (ResNeXt-50 at P7, measured: 0.961 against
    JAX's own 0.958)."""
    jt, jh, pt, ph = _run(case, "bfloat16")[:4]
    ft, fh = _run(case, "float32")[:2]
    pairs = [(k, pt[k], jt[k], ft[k]) for k in ("C3", "C4", "C5")] + [
        (h + pn, ph[h][pn], jh[h][pn], fh[h][pn])
        for h in HEADS for pn in LEVELS]
    for name, got, want, f32 in pairs:
        noise = _rel(want, f32)
        assert _rel(got, want) <= NOISE_RATIO * noise, (
            case, name, _rel(got, want), noise)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.95, name


@pytest.mark.parametrize("case", CASES)
def test_backbone_int8_matches_jax(case):
    """int8 serving (B6's plain version) on the float weights: every int8
    block fed JAX's own input matches JAX's block (‖Δ‖₂/‖ref‖₂ ≤ 1e-3,
    most of them ≤ 1e-6);
    the heads no farther from JAX's int8 heads than those are from JAX's
    float32 heads (times 1.25), and within rel. L2 0.25 and correlation
    0.98 where JAX's own int8 heads are."""
    jt, jh, pt, ph, inter, model = _run(case, "float32", "int8")
    fh = _run(case, "float32")[1]
    blocks = {"resnet_50": "ResNeXtBottleneck", "mobilenet_v2": "Bottleneck",
              "densenet": "DenseBlock"}[case]
    names = sorted((k for k in inter if k.startswith(blocks + "_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    assert names
    rels = []
    with torch.inference_mode():
        for prev, name in zip(names, names[1:]):
            if case == "densenet":  # a transition sits between blocks
                idx = int(name.rsplit("_", 1)[1])
                x = inter[f"TransitionLayer_{idx - 1}"]["__call__"][0]
            else:
                x = inter[prev]["__call__"][0]
            want = np.asarray(inter[name]["__call__"][0])
            block = getattr(model.backbone_net, name)
            got = _np(block(_nchw(np.asarray(x))).permute(0, 2, 3, 1))
            rels.append(_rel(got, want))
    assert max(rels) <= 1e-3, (case, rels)
    assert np.median(rels) <= 1e-6, (case, rels)
    for h in HEADS:
        for pn in LEVELS:
            got, want, f32 = ph[h][pn], jh[h][pn], fh[h][pn]
            assert np.isfinite(got).all()
            rel = _rel(got, want)
            corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
            jax_rel = _rel(want, f32)
            jax_corr = np.corrcoef(want.ravel(), f32.ravel())[0, 1]
            assert rel <= NOISE_RATIO * jax_rel, (case, h, pn, rel, jax_rel)
            if jax_rel <= 0.25 and jax_corr >= 0.98:
                assert rel <= 0.25 and corr >= 0.98, (case, h, pn, rel, corr)


# The backbones' int8 convs, stems float: (backbone convs, FPN convs).
INT8_CONVS = {"resnet_50": 52, "resnet_50_dense": 52, "mobilenet_v2": 34,
              "densenet_121": 119, "densenet_169": 167}


@pytest.mark.parametrize("backbone", sorted(INT8_CONVS))
def test_parameter_names_match_jax(backbone):
    """The port's state_dict keys and shapes are ``params_from_flax`` of
    JAX's ``eval_shape`` parameter tree at 640 px, for every backbone;
    ``init_params`` draws grouped kernels at fan-in C/g·k·k."""
    cfg = JaxModelConfig(backbone=backbone, num_classes=80)
    jmodel = jret.RetinaNet.from_config(cfg, 9, 80)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 640, 640, 3)),
        training=False))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = _leaf_path(path)
        shape = leaf.shape
        if name.endswith("kernel"):
            shape = (shape[3], shape[2], shape[0], shape[1])
        want[name.replace("/", ".")] = tuple(shape)
    model = tret.RetinaNet.from_config(
        tcfg.ModelConfig(backbone=backbone, num_classes=80), 9, 80)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_grouped_kernels_init_at_their_fan_in():
    state = init_params(tcfg.Config(), torch.Generator().manual_seed(0), 80)
    k = state["backbone_net.ResNeXtBottleneck_15.Conv_0.kernel"]
    assert tuple(k.shape) == (1024, 32, 3, 3)
    assert abs(float(k.std()) / np.sqrt(2.0 / (32 * 9)) - 1) < 0.01


def test_l2_regularization_takes_mobilenet_scale():
    """l2_regularization: backbone kernels at 4e-5 for MobileNetV2, 1e-4
    elsewhere, over the new parameter tree (depthwise kernels included)."""
    model = tret.RetinaNet.from_config(
        tcfg.ModelConfig(backbone="mobilenet_v2", num_classes=4), 9, 4)
    model.load_state_dict(params_from_flax(_flat("mobilenet_v2")))
    got = float(tret.l2_regularization(model.named_parameters(),
                                       "mobilenet_v2"))
    want = float(jax.jit(jret.l2_regularization, static_argnums=(1, 2))(
        to_flax(_flat("mobilenet_v2")), "mobilenet_v2", 1e-4))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- B6 at the new backbones' int8 shapes --------------------------------------


@pytest.mark.parametrize("case", ["grouped32", "c24_f16", "c16_f96_3x3"])
def test_int8_plain_matches_jax_bitwise(case):
    """B6's plain version and the prepared-weights path (block-diagonal
    dense, C and F padded) equal JAX's ``_int8_conv`` bitwise: a
    cardinality-32 grouped 3×3 at stride 2 (ResNeXt's res5 conv, narrowed),
    MobileNetV2's C = 24 → F = 16 1×1, and a 3×3 at C = 16, F = 96."""
    b, h, w, c, f, k, s, g = {
        "grouped32": (2, 9, 7, 256, 256, 3, 2, 32),
        "c24_f16": (2, 9, 7, 24, 16, 1, 1, 1),
        "c16_f96_3x3": (2, 9, 7, 16, 96, 3, 1, 1)}[case]
    rng = np.random.RandomState(11)
    x = rng.randn(b, h, w, c).astype(ml_dtypes.bfloat16)
    kernel = (rng.randn(k, k, c // g, f) / np.sqrt(k * k * c / g)).astype(
        np.float32)
    want = np.asarray(jl._int8_conv(jnp.asarray(x), jnp.asarray(kernel),
                                    (s, s), "SAME", g, jnp.bfloat16),
                      np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    oihw = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    plain = b6.int8_conv_plain(xt, oihw, s, torch.bfloat16, groups=g)
    prepared = b6.int8_conv(xt, oihw, s, weights=b6.prepare_weights(oihw, g),
                            groups=g)
    for got in (plain, prepared):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), want)


def test_prepared_weights_are_padded_block_diagonal():
    """``prepare_weights`` of a grouped kernel: w_q ``[Fp, k·k·Cp]`` with
    C and F padded to 64 by zeros, the block-diagonal dense kernel of the
    grouped quantized one inside; s_w unpadded and equal to the grouped
    kernel's.  The card's geometry takes C and F multiples of 8 and no
    other; x_q's bytes follow the padded C."""
    kernel = torch.randn(96, 24 // 8, 3, 3)
    wts = b6.prepare_weights(kernel, groups=8)
    assert tuple(wts.w_q.shape) == (128, 9 * 64) and wts.groups == 8
    w_q, s_w = b6.quantize_weights(kernel)
    assert torch.equal(wts.s_w, s_w)
    assert torch.equal(wts.dense_oihw(), block_diagonal(w_q, 8))
    layout = wts.w_q.view(128, 3, 3, 64)
    assert not layout[96:].any() and not layout[..., 24:].any()
    geom = b6._geometry((2, 9, 7, 24), torch.bfloat16, (96, 3, 3, 3), 1,
                        torch.bfloat16, 8)
    assert geom[3] == (2, 9, 7, 96) and geom[2] == 64
    assert b6.xq_bytes((2, 9, 7, 24)) == 2 * 9 * 7 * 64
    with pytest.raises(ValueError, match="divisible by 8"):
        b6._geometry((2, 9, 7, 20), torch.bfloat16, (96, 20, 1, 1), 1,
                     torch.bfloat16)
    with pytest.raises(ValueError, match="in 8 groups"):
        b6._geometry((2, 9, 7, 24), torch.bfloat16, (96, 24, 3, 3), 1,
                     torch.bfloat16, 8)


# -- dropout -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rate_and_scale(dtype):
    """The share of zeros lies within 4σ of the rate; every survivor is
    exactly x / (1 − rate) in x's dtype (1 − rate rounded to it, as flax's
    division by a weakly typed Python float); the output stays
    channels_last."""
    rate, n = 0.2, 4 * 16 * 24 * 24
    x = (torch.rand(4, 16, 24, 24) + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    y = tl.dropout(x, rate, torch.Generator().manual_seed(0))
    zeros = float((y == 0).float().mean())
    assert abs(zeros - rate) <= 4 * np.sqrt(rate * (1 - rate) / n)
    kept = y != 0
    scale = torch.tensor(1 - rate, dtype=dtype)
    assert torch.equal(y[kept], (x / scale)[kept])
    assert y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_dropout_masks_follow_the_seed():
    """The same seed and site give the same mask; another site or seed
    another; not training (or rate 0) is the identity; training without
    keys raises."""
    x = torch.randn(2, 8, 6, 6)
    drop = tl.Dropout(0.3)
    a = drop(x, True, tl.DropoutKeys(7))
    assert torch.equal(a, drop(x, True, tl.DropoutKeys(7)))
    assert not torch.equal(a, drop(x, True, tl.DropoutKeys(8)))
    drop.site = 1
    assert not torch.equal(a, drop(x, True, tl.DropoutKeys(7)))
    assert drop(x, False, tl.DropoutKeys(7)) is x
    assert tl.Dropout(0.0)(x, True) is x
    with pytest.raises(ValueError, match="DropoutKeys"):
        drop(x, True)
    gen = torch.Generator().manual_seed(3)
    assert tl.DropoutKeys.draw(gen).seed != tl.DropoutKeys.draw(gen).seed


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "densenet"])
def test_remat_gradients_equal_no_remat_with_dropout(backbone):
    """With dropout 0.2, one training forward and backward under ``remat``
    (each block or composite recomputed in the backward, its masks drawn
    again from the same keys) gives the no-remat gradients, from the same
    generator seed (fp32, ≤1e-6·max|g|: the recomputation repeats the
    forward's arithmetic)."""
    images = torch.from_numpy(_images(64))
    grads = []
    for remat in (False, True):
        with _backbone(backbone) as name:
            model = tret.RetinaNet.from_config(tcfg.ModelConfig(
                backbone=name, num_classes=CLASSES, compute_dtype="float32",
                remat=remat), 9, CLASSES)
        model.load_state_dict(params_from_flax(_flat(backbone)))
        out = model(images, training=True,
                    generator=torch.Generator().manual_seed(5))
        loss = sum((v.float() ** 2).mean() for h in HEADS
                   for v in out[h].values())
        params = list(model.parameters())
        grads.append(torch.autograd.grad(loss, params))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(
            a.abs().max().clamp(min=1e-12))), backbone
