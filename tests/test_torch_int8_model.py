"""The port's int8 serving path (``quantize="int8"``: int8 backbone and FPN
convs, float stem and heads) against the JAX package's on the CPU, on the
same numpy-seeded float weights: the FPN alone, the 64-px flagship, and
``Detector``/``Detector.from_export`` serving the float weights as they
are."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinanet_tpu.config import Config
from retinanet_tpu.export import export_model
from retinanet_tpu.models.fpn import FPN as JaxFPN
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.infer import Detector
from retinanet_tpu_torch.models.fpn import FPN
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops import int8_conv as b6

from torch_parity import flagship_config, random_flat_params, to_flax

torch.set_num_threads(2)

LEVELS = ("P3", "P4", "P5", "P6", "P7")


@pytest.fixture(scope="module")
def flat():
    return random_flat_params(flagship_config(), seed=0)


def test_int8_fpn_matches_jax():
    """fp32 ``FPN(quantize=True)``, all seven convs int8, against JAX's.
    P5-P7 agree to ≤ 2.6e-5; a merge input one fp32 ulp from a rounding
    boundary lands on the other integer, so P4 and P3 part by
    ‖Δ‖₂/‖ref‖₂ 4e-4 and 1.9e-3 (measured).  Each level is held to a
    quarter of the float FPN's distance from JAX's int8 one (measured at
    most 0.086 of it), so the int8 path is the one taken."""
    rng = np.random.RandomState(0)
    feats = {"C3": rng.randn(2, 16, 16, 64), "C4": rng.randn(2, 8, 8, 64),
             "C5": rng.randn(2, 4, 4, 128)}
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    jfpn = JaxFPN(channels=64, quantize=True, dtype=jnp.float32)
    jin = {k: jnp.asarray(v) for k, v in feats.items()}
    shapes = jax.eval_shape(lambda: jfpn.init(jax.random.PRNGKey(0), jin))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        name = "/".join(p.key for p in path)
        scale = (np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
                 if name.endswith("kernel") else 0.3)
        flat[name] = (rng.randn(*leaf.shape) * scale
                      + (name.endswith("gamma"))).astype(np.float32)
    want = jax.jit(jfpn.apply)({"params": to_flax(flat)}, jin)
    floats = jax.jit(JaxFPN(channels=64, dtype=jnp.float32).apply)(
        {"params": to_flax(flat)}, jin)
    fpn = FPN({"C3": 64, "C4": 64, "C5": 128}, 64, quantize=True)
    fpn.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        got = fpn({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                   for k, v in feats.items()})
    for pn in LEVELS:
        g = got[pn].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[pn])
        rel = lambda a: np.linalg.norm(a - w) / np.linalg.norm(w)
        assert rel(g) <= 0.25 * rel(np.asarray(floats[pn])), pn


def test_int8_flagship_matches_jax(flat):
    """The fp32 int8 flagship at 64 px, batch 2, against JAX's int8 model
    on the same float weights (the float state_dict loads as it is).

    The int8 model amplifies any difference: an activation within ~1e-6 of
    a rounding boundary lands on the other integer in one of the two, its
    conv output moves by a quantum, and the next GroupNorm carries that
    into the next quantization.  The port's stem already differs from
    JAX's by 1.4e-6 (fp32 sum order), which flips an input of res2 b0, and
    the heads end as far from JAX's int8 heads (‖Δ‖₂/‖ref‖₂ 0.09-0.15,
    correlation ≥ 0.988, measured) as JAX's float heads are (0.10-0.14).
    So the heads are held to ‖Δ‖₂/‖ref‖₂ ≤ 0.25 and correlation ≥ 0.98,
    and each int8 block after the first, fed JAX's own input to it, to
    JAX's output: ‖Δ‖₂/‖ref‖₂ ≤ 1e-4 and 99.9% of elements within 1e-4
    (measured: ≤ 1.1e-7 and all within 1.4e-6, but for one block with a
    flipped input, 1.4e-5 and 99.96%)."""
    images = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    cfg = flagship_config(quantize="int8")
    jmodel = JaxRetinaNet.from_config(cfg, 9, 4)
    want, inter = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, capture_intermediates=True,
        mutable=["intermediates"]))(to_flax(flat), jnp.asarray(images))
    taps = inter["intermediates"]["backbone_net"]
    model = RetinaNet.from_config(cfg, 9, 4)
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
        for i in range(1, 16):
            block = getattr(model.backbone_net, f"ResNetBottleneck_{i}")
            x = np.asarray(taps[f"ResNetBottleneck_{i - 1}"]["__call__"][0])
            w = np.asarray(taps[f"ResNetBottleneck_{i}"]["__call__"][0])
            g = block(torch.from_numpy(x.copy()).permute(0, 3, 1, 2))
            d = g.permute(0, 2, 3, 1).numpy() - w
            rel = np.linalg.norm(d) / np.linalg.norm(w)
            assert rel <= 1e-4 and (np.abs(d) <= 1e-4).mean() >= 0.999, (
                i, rel)
    for head in ("classifications", "regressions"):
        for pn in LEVELS:
            w = np.asarray(want[head][pn])
            g = got[head][pn].numpy()
            assert g.shape == w.shape and g.dtype == np.float32
            assert np.isfinite(g).all()
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
            assert rel <= 0.25 and corr >= 0.98, (head, pn, rel, corr)


def test_int8_detector_serves_float_weights(flat, tmp_path):
    """``Detector`` with ``quantize="int8"`` takes a JAX export file of the
    float model and its state_dict unchanged (no new parameters), and
    serves on the CPU through the plain int8 convolution."""
    config = Config(model=flagship_config(quantize="int8"))
    config = config.replace(data=dataclasses.replace(config.data,
                                                     image_size=64))
    names = ["a", "b", "c", "d"]
    path = str(tmp_path / "m.npz")
    export_model(to_flax(flat), names, "resnet_50_dense", 64, path)
    served = Detector.from_export(path, config=config, device="cpu")
    assert served.config.model.quantize == "int8"
    direct = Detector(config, params_from_flax(flat), names, device="cpu")
    images = (np.random.RandomState(5).rand(1, 64, 64, 3) * 255).astype(
        np.uint8)
    out = served(images)
    assert all(bool(torch.isfinite(t.float()).all()) for t in
               (out.boxes, out.scores))
    for got, want in zip(out, direct(images)):
        assert torch.equal(got, want)
    assert b6.int8_conv.launches == 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_quantize_keeps_state_dict_keys(quantize):
    """int8 adds no parameter: both models have the 208 flagship leaves."""
    model = RetinaNet.from_config(flagship_config(quantize=quantize), 9, 4)
    assert len(model.state_dict()) == 208
