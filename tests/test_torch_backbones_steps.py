"""The other backbones (``resnet_50`` = ResNeXt-50, the default;
``mobilenet_v2``; ``densenet_121``/``densenet_169``) through the port's
entry points on the CPU: the FLOP count against JAX's in both modes, two
fp32 train steps against JAX's, and ``train`` → ``export`` → ``evaluate``
→ ``detect`` for each backbone.  ``test_torch_backbones.py`` holds the
modules; this file is split from it so that the two run on two workers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.config import ModelConfig as JaxModelConfig
from retinanet_tpu.infer import forward_gflops_per_image as jax_gflops
from retinanet_tpu.models import retinanet as jret
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.train import TrainState as JaxTrainState
from retinanet_tpu.train import build_optimizer as jax_optimizer
from retinanet_tpu.train import make_train_step as jax_step
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.infer import forward_gflops_per_image
from retinanet_tpu_torch.models import retinanet as tret
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.train import create_train_state, make_train_step

from torch_parity import random_flat_params, to_flax

torch.set_num_threads(2)

BATCH, CLASSES = 2, 4


# -- FLOPs ---------------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 640])
@pytest.mark.parametrize("backbone", ["resnet_50", "mobilenet_v2",
                                      "densenet_121", "densenet_169"])
def test_forward_gflops_match_jax(backbone, size):
    """Equal to JAX's jaxpr count to 1e-9 relative in both modes (640 px:
    ResNeXt-50 327.8771 GFLOP as it runs, 232.7974 truly grouped).  Only
    ResNeXt-50 has a conv that ``force_true_grouped`` changes, so JAX is
    traced in both modes there and once for the others."""
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, backbone=backbone),
        data=dataclasses.replace(jcfg.data, image_size=size))
    cfg = tcfg.Config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, backbone=backbone),
        data=dataclasses.replace(cfg.data, image_size=size))
    want = jax_gflops(jcfg)
    for algorithmic in (False, True):
        if algorithmic and backbone == "resnet_50":
            want = jax_gflops(jcfg, algorithmic=True)
        got = forward_gflops_per_image(cfg, algorithmic=algorithmic)
        np.testing.assert_allclose(got, want, rtol=1e-9)
        if backbone == "resnet_50" and size == 640:
            assert round(got, 4) == (232.7974 if algorithmic else 327.8771)


# -- training ------------------------------------------------------------------


def _batch(size=64, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, size, size, 3).astype(np.float32)
    boxes = np.zeros((BATCH, 100, 4), np.float32)
    corner = rng.rand(BATCH, 3, 2) * 0.3
    boxes[:, :3] = np.concatenate(
        [corner, corner + 0.35 + rng.rand(BATCH, 3, 2) * 0.35], -1)
    ids = np.zeros((BATCH, 100), np.int32)
    ids[:, :3] = rng.randint(0, CLASSES, (BATCH, 3))
    mask = np.zeros((BATCH, 100), bool)
    mask[:, :3] = True
    return images, boxes, ids, mask


@pytest.mark.parametrize("backbone", ["resnet_50", "mobilenet_v2"])
def test_two_train_steps_match_jax(backbone):
    """Two fp32 momentum-SGD steps at 64 px from JAX's parameters, dropout
    0, on one batch: step 1's loss within 1e-4 relative of JAX's (the
    flagship's bound; fp32 sums in another order), and step 2's within
    1e-4 for MobileNetV2.  ResNeXt-50 at 64 px normalizes each res5 channel
    on its own over 2×2 pixels, where E[x²]−E[x]² in fp32 cancels, so its
    fp32 gradient is ill-conditioned in both packages: their first updates
    stand 0.87% (JAX) and 2.6% (port) from a float64 step of the port
    (measured; the dense flagship's and MobileNetV2's: 5e-5 and 8e-5, equal
    in both), and step 2's loss then agrees to 9.3e-4: bound 2e-3."""
    flat = random_flat_params(JaxModelConfig(
        backbone=backbone, num_classes=CLASSES, compute_dtype="float32"), 0)
    jcfg = JaxConfig(model=JaxModelConfig(
        backbone=backbone, num_classes=CLASSES, compute_dtype="float32",
        dropout_rate=0.0))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, image_size=64,
                                                 batch_size=BATCH))
    jmodel = jret.RetinaNet.from_config(jcfg.model, 9, CLASSES)
    params = to_flax(flat)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params,
                          jax_optimizer(jcfg.train).init(params))
    batch = _batch()
    step = jax.jit(jax_step(jmodel, jax_levels(), jcfg, with_metrics=False))
    want = []
    for i in range(2):
        state, metrics = step(state, *map(jnp.asarray, batch),
                              jax.random.PRNGKey(i))
        want.append(float(metrics["total_loss"]))

    cfg = tcfg.Config(model=tcfg.ModelConfig(
        backbone=backbone, num_classes=CLASSES, compute_dtype="float32",
        dropout_rate=0.0))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=64,
                                               batch_size=BATCH))
    model = tret.RetinaNet.from_config(cfg.model, 9, CLASSES)
    tstate = create_train_state(model, cfg, params_from_flax(flat))
    tstep = make_train_step(model, build_levels(), cfg, with_metrics=False)
    gen = torch.Generator().manual_seed(1)
    got = []
    for _ in range(2):
        tstate, metrics = tstep(tstate, *map(torch.from_numpy, batch), gen)
        got.append(float(metrics["total_loss"]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(
        got[1], want[1], rtol=2e-3 if backbone == "resnet_50" else 1e-4)
    assert got[1] < got[0]


# -- entry points --------------------------------------------------------------


def _fp32_parse(real):
    """The training CLI's parse with fp32 compute (this CPU's bf16 conv
    weight gradient is unreliable at 64 px, ROADMAP C.10)."""
    def parse(argv):
        config, device = real(argv)
        return config.replace(model=dataclasses.replace(
            config.model, compute_dtype="float32")), device
    return parse


@pytest.mark.parametrize("backbone", ["resnet_50", "mobilenet_v2",
                                      "densenet_121", "densenet_169"])
def test_cli_chain_runs(backbone, tmp_path, capsys):
    """``train`` (one step, dropout at its default 0.2) → ``export`` →
    ``evaluate --from-export`` → ``detect --from-export`` on the CPU at 64
    px for each backbone; ``save_backbone`` / ``load_backbone`` round-trip
    its trained backbone exactly."""
    from retinanet_tpu_torch import detect, evaluate, export, train
    from retinanet_tpu_torch.utils.pretrained import (load_backbone,
                                                      save_backbone)

    dataset = ["shapes", str(tmp_path / "s"), "2", "64"]
    exp, artifact = str(tmp_path / "e"), str(tmp_path / "m.npz")
    real = train.parse_args
    train.parse_args = _fp32_parse(real)
    try:
        state = train.main(["--dataset", *dataset, "--experiment", exp,
                            "--backbone", backbone, "--scale", "64",
                            "--batch-size", "2", "--epochs", "1",
                            "--steps-per-epoch", "1", "--device", "cpu"])
    finally:
        train.parse_args = real
    assert state.step == 1
    export.main(["--experiment", exp, "--backbone", backbone, "--scale",
                 "64", "--dataset", *dataset, "--out", artifact, "--device",
                 "cpu"])
    capsys.readouterr()
    metrics = evaluate.main(["--dataset", *dataset, "--from-export",
                             artifact, "--batch-size", "2", "--device",
                             "cpu"])
    assert set(metrics) >= {"mAP", "AP50", "AR@100"}
    image = str(tmp_path / "i.png")
    from PIL import Image
    from retinanet_tpu_torch.data.loaders.shapes import Shapes
    Image.fromarray(next(iter(Shapes(None, 1, (64, 64))))["image"]).save(
        image)
    records = detect.main([image, "--from-export", artifact, "--device",
                           "cpu", "--score-threshold", "0.0"])
    assert records and {r["image"] for r in records} == {image}
    params = {k: v.detach() for k, v in state.params.items()}
    save_backbone(params, str(tmp_path / "b.npz"))
    blank = {k: torch.zeros_like(v) for k, v in params.items()}
    restored = load_backbone(blank, str(tmp_path / "b.npz"))
    for k, v in params.items():
        want = v if k.startswith("backbone_net.") else blank[k]
        assert torch.equal(restored[k], want), k
