"""The port's full-width flagship (resnet_50_dense RetinaNet) against JAX
``model.apply`` (unfused) on the CPU at 64 px, batch 2, 4 classes, on the
same numpy-seeded weights; plus the export round trip into the port."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.export import export_model
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.export import load_exported, params_from_flax
from retinanet_tpu_torch.models.retinanet import RetinaNet, build_backbone

from torch_parity import flagship_config, random_flat_params, to_flax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flat():
    return random_flat_params(flagship_config(), seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)


def _run_both(flat, images, compute_dtype, **port_kw):
    cfg = flagship_config(compute_dtype=compute_dtype)
    jmodel = JaxRetinaNet.from_config(cfg, 9, 4)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        to_flax(flat), jnp.asarray(images))
    model = RetinaNet.from_config(flagship_config(
        compute_dtype=compute_dtype, **port_kw), 9, 4)
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    return want, got


def test_flagship_fp32_matches_jax(flat, images):
    """fp32 compute: every level's logits and regressions ≤1e-3 (fp32
    convs summed in another order through 70 conv layers)."""
    want, got = _run_both(flat, images, "float32")
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            w = np.asarray(want[head][pn])
            g = got[head][pn].numpy()
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=1e-3, err_msg=head + pn)


def test_flagship_bf16_matches_jax(flat, images):
    """bf16 compute, the serving dtype.  Each conv output and each GN
    affine step rounds to bf16, the two frameworks sum every conv in
    another fp32 order (and XLA may skip an intermediate rounding), so
    values land on neighbouring bf16 steps and GroupNorm carries that noise
    through ~70 layers.  Measured on this input, per level: mean |Δ| ≤ 0.04
    and max |Δ| ≤ 0.24 on values up to 5.3, correlation ≥ 0.9988.  Bound:
    mean |Δ| ≤ 0.06, max |Δ| ≤ 0.1·max(1, max|ref|), correlation > 0.998.
    The fused port (the kernel's plain version on the CPU) equals the
    unfused port bitwise."""
    want, got = _run_both(flat, images, "bfloat16")
    fused = RetinaNet.from_config(flagship_config(
        compute_dtype="bfloat16", fused_blocks=True, fused_res2=True), 9, 4)
    fused.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        got_fused = fused(torch.from_numpy(images))
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            w = np.asarray(want[head][pn], np.float32)
            g = got[head][pn]
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, got_fused[head][pn])
            d = np.abs(g.float().numpy() - w)
            assert d.mean() <= 0.06, (head, pn, d.mean())
            assert d.max() <= 0.1 * max(1.0, np.abs(w).max()), (head, pn)
            corr = np.corrcoef(g.float().numpy().ravel(), w.ravel())[0, 1]
            assert corr > 0.998, (head, pn, corr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_roundtrip_into_port(flat, tmp_path, dtype):
    """JAX ``export_model`` → port ``load_exported`` gives the exported
    tensors (bf16 files: the bf16-rounded values) under port names."""
    path = str(tmp_path / "m.npz")
    n = export_model(to_flax(flat), ["a", "b", "c", "d"], "resnet_50_dense",
                     64, path, dtype=dtype)
    assert n == len(flat) == 208
    meta, state, names, size = load_exported(path)
    assert meta["backbone"] == "resnet_50_dense" and size == 64
    assert names == ["a", "b", "c", "d"]
    want = params_from_flax(flat)
    assert set(state) == set(want)
    for k, v in want.items():
        expect = v.numpy()
        if dtype == "bfloat16":
            expect = expect.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert state[k].dtype == torch.float32
        np.testing.assert_array_equal(state[k].numpy(), expect, err_msg=k)
    model = RetinaNet(backbone="resnet_50_dense", num_classes=4)
    model.load_state_dict(state)


def test_unported_backbones_raise():
    """Every backbone builds now (ROADMAP A.6 is done) and only an unknown
    name raises; int8 serving quantizes each one's block convs (52 / 34 /
    119 / 167 / 52) and keeps its stem float."""
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone("resnet_101")
    counts = {"resnet_50": 52, "mobilenet_v2": 34, "densenet_121": 119,
              "densenet_169": 167, "resnet_50_dense": 52}
    for name, count in counts.items():
        net = build_backbone(name, quantize=True)
        convs = [m for m in net.modules() if hasattr(m, "quantize")
                 and hasattr(m, "kernel")]
        assert sum(c.quantize for c in convs) == count, name
        stem = net.Conv_0 if name.startswith("densenet") else \
            net.ConvGN_0.Conv_0
        assert not stem.quantize, name
    model = RetinaNet.from_config(Config().model)
    assert model.backbone == "resnet_50"


def test_bare_retinanet_is_jax_bare_retinanet():
    """``RetinaNet()`` with every argument at its default builds the model
    that JAX's ``RetinaNet()`` builds (ResNeXt-50, 80 classes, 9 anchors):
    the same parameter names and shapes across the weight bridge
    (ROADMAP C.14)."""
    jmodel = JaxRetinaNet()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            training=False))["params"]
    flat = {"/".join(k): np.zeros(v.shape, np.float32) for k, v in
            traverse_util.flatten_dict(shapes).items()}
    want = {k: tuple(v.shape) for k, v in params_from_flax(flat).items()}
    with torch.device("meta"):
        model = RetinaNet()
    assert model.backbone == jmodel.backbone == "resnet_50"
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
