"""``--init-backbone`` (the port's ``utils/pretrained.py``) and
``make_classmap_fn`` against the JAX package on the CPU.

``load_pretrained`` of the port gives exactly ``params_from_flax`` of
JAX's ``load_pretrained`` on the same seeded inputs: a ``save_backbone``
npz, a torchvision-named ``.pt`` state_dict, a foreign-named npz matched
by shape in order; a partial archive raises in both.  A fresh ``Trainer``
takes the backbone from the file, a resumed one ignores it.  The classmap
counts equal JAX's on the same He-scaled parameters and batch.
Parameters come from ``torch_parity.random_flat_params`` (numpy seeded,
the flagship with 3 classes)."""

import contextlib
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.data.loaders.shapes import Shapes as JaxShapes
from retinanet_tpu.data.pipeline import build_pipeline as jax_pipeline
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.train import make_classmap_fn as jax_classmap
from retinanet_tpu.utils import pretrained as jax_pretrained
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.train import Trainer, make_classmap_fn
from retinanet_tpu_torch.utils import pretrained

from test_pretrained_torch import synth_torchvision_resnet50
from torch_parity import flagship_config, random_flat_params, to_flax

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def params():
    """Two parameter sets: the source of saved backbones, and the one they
    are loaded into."""
    return (random_flat_params(flagship_config(3), seed=1),
            random_flat_params(flagship_config(3), seed=2))


def _both(flat, path, backbone="resnet_50_dense"):
    """(port result, JAX result as a port state_dict, their reports)."""
    got, got_report = pretrained.load_pretrained(
        params_from_flax(flat), path, backbone=backbone)
    want, want_report = jax_pretrained.load_pretrained(
        to_flax(flat), path, backbone=backbone)
    want = params_from_flax({"/".join(k): np.asarray(v) for k, v in
                             traverse_util.flatten_dict(want).items()})
    return got, want, got_report, want_report


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_save_backbone_npz_equals_jax(params, tmp_path):
    """The port writes JAX's archive array for array, and loading one is
    the exact restore (no report) in both."""
    source, target = params
    path, mine = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_pretrained.save_backbone(to_flax(source), path)
    pretrained.save_backbone(params_from_flax(source), mine)
    with np.load(path) as a, np.load(mine) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    got, want, got_report, want_report = _both(target, path)
    assert got_report is None and want_report is None
    _assert_equal(got, want)
    prefix = "backbone_net."
    src = params_from_flax(source)
    for k, v in got.items():
        ref = src[k] if k.startswith(prefix) else params_from_flax(target)[k]
        assert torch.equal(v, ref), k


def test_torchvision_state_dict_equals_jax(params, tmp_path):
    """A torchvision resnet50 state_dict of seeded numpy, saved as ``.pt``,
    matched wholly by name in both."""
    path = str(tmp_path / "tv.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                synth_torchvision_resnet50(seed=3).items()}, path)
    got, want, got_report, want_report = _both(params[1], path)
    assert got_report == want_report
    assert got_report["unmatched"] == [] and got_report["matched_by_shape"] \
        == [] and len(got_report["matched_by_name"]) == 159
    _assert_equal(got, want)


def test_foreign_npz_matches_by_shape_as_jax(params, tmp_path):
    """Foreign names in torch layout (OIHW kernels, ``.weight``): every
    target found by shape, in the same order as JAX's, repeated shapes
    included."""
    source, target = params
    backbone = sorted((k[len("backbone_net/"):], v) for k, v in source.items()
                      if k.startswith("backbone_net/"))
    backbone.sort(key=lambda kv: pretrained._natural_key(kv[0]))
    weights = {f"blob{i}.weight": (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                   else v)
               for i, (_, v) in enumerate(backbone)}
    path = str(tmp_path / "foreign.npz")
    np.savez(path, **weights)
    got, want, got_report, want_report = _both(target, path)
    assert got_report == want_report
    assert got_report["matched_by_name"] == [] and \
        len(got_report["matched_by_shape"]) == len(backbone)
    _assert_equal(got, want)


@pytest.mark.parametrize("archive", ["torchvision", "foreign"])
def test_partial_init_raises_in_both(params, tmp_path, archive):
    if archive == "torchvision":
        weights = {k: v for k, v in synth_torchvision_resnet50(
            seed=3).items() if "layer3" not in k}
        match = "missing"
    else:
        weights = {f"w{i}": v for i, v in enumerate(
            v for k, v in params[0].items() if "ResNetBottleneck_1" in k)}
        match = "partial init"
    path = str(tmp_path / "partial.npz")
    np.savez(path, **weights)
    with pytest.raises(ValueError, match=match):
        pretrained.load_pretrained(params_from_flax(params[1]), path,
                                   backbone="resnet_50_dense")
    with pytest.raises(ValueError, match=match):
        jax_pretrained.load_pretrained(to_flax(params[1]), path,
                                       backbone="resnet_50_dense")


def test_trainer_inits_the_backbone_on_a_fresh_start_only(params, tmp_path,
                                                          caplog):
    """``train.init_backbone``: the fresh state's backbone is the file's
    and the rest is the seeded init; with a checkpoint in the experiment
    the checkpoint wins."""
    path = str(tmp_path / "bb.npz")
    pretrained.save_backbone(params_from_flax(params[0]), path)
    config = tcfg.Config(
        model=tcfg.ModelConfig(backbone="resnet_50_dense", num_classes=3,
                               compute_dtype="float32"),
        data=tcfg.DataConfig(image_size=SIZE, batch_size=2, num_workers=1),
        train=tcfg.TrainConfig(experiment=str(tmp_path / "exp"),
                               init_backbone=path))
    trainer = Trainer(config, loader=Shapes(None, 2, (SIZE, SIZE)),
                      device="cpu")
    with caplog.at_level(logging.INFO):
        state = trainer._initial_state()
    assert f"init backbone from {path} (exact npz restore)" in caplog.text
    want = params_from_flax(params[0])
    for k, v in state.params.items():
        if k.startswith("backbone_net."):
            assert torch.equal(v.detach(), want[k]), k
    head = "classification_subnet.Conv_0.bias"
    assert not torch.equal(state.params[head].detach(), want[head])
    trainer.save_checkpoint(state)
    with torch.no_grad():
        for v in state.params.values():
            v.zero_()
    trainer.save_checkpoint(state)  # the same step, now all zeros
    trainer.wait_for_checkpoints()
    caplog.clear()
    with caplog.at_level(logging.INFO):
        resumed = trainer._initial_state()
    assert "init backbone" not in caplog.text
    assert all(not v.any() for v in resumed.params.values())
    assert os.listdir(trainer.checkpoint_dir) == ["step_0"]
    shutil.rmtree(trainer.checkpoint_dir)  # ~300 MB


def test_classmap_counts_equal_jax(params):
    """GT and predicted fg counts per cell and level exactly, on He-scaled
    parameters whose class logits spread around 0 (the π prior of a fresh
    model would predict nothing), one 64-px batch of 2 from JAX's training
    pipeline."""
    cfg = JaxConfig(model=flagship_config(3))
    cfg = cfg.replace(data=cfg.data.__class__(image_size=SIZE, batch_size=2,
                                              num_workers=1))
    pipe = jax_pipeline(JaxShapes(None, 4, (SIZE, SIZE)), cfg.data,
                        training=True, seed=0)
    with contextlib.closing(pipe.prefetched(0)) as stream:
        b = next(stream)
    arrays = (b.images, b.boxes, b.class_ids, b.box_mask)
    model = JaxRetinaNet.from_config(cfg.model, 9, 3)
    want_true, want_pred = jax_classmap(model, jax_levels(), cfg)(
        to_flax(params[0]), *(jnp.asarray(a) for a in arrays))

    config = tcfg.Config(model=tcfg.ModelConfig(
        backbone="resnet_50_dense", num_classes=3, compute_dtype="float32"))
    port = RetinaNet.from_config(config.model, 9, 3)
    port.load_state_dict(params_from_flax(params[0]))
    true, pred = make_classmap_fn(port, build_levels(), config)(
        *(torch.from_numpy(a) for a in arrays))
    assert set(true) == set(want_true) == {"P3", "P4", "P5", "P6", "P7"}
    assert sum(int(v.sum()) for v in want_true.values()) > 0
    assert sum(int(v.sum()) for v in want_pred.values()) > 0
    for pn in want_true:
        np.testing.assert_array_equal(true[pn].numpy(),
                                      np.asarray(want_true[pn]))
        np.testing.assert_array_equal(pred[pn].numpy(),
                                      np.asarray(want_pred[pn]))
