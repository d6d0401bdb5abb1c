"""The port's evaluators and export writer against the JAX package's:
``COCOEvaluator`` and ``VOCEvaluator`` on planted detections (jittered
ground truth, false positives, crowd and difficult ignores, equal scores,
empty images), exactly equal metrics and per-class AP; ``evaluate_model``
with the port's fp32 ``Detector`` on the CPU through JAX's
``evaluate_model`` and through the port's, exactly equal (the Detector
itself is held to JAX's by ``test_torch_infer.py``); and the write side of
the export: a port-written npz is leaf for leaf, bit for bit, JAX's own
export of the same parameters, and JAX's ``load_exported`` reads it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinanet_tpu import config as jcfg
from retinanet_tpu import eval_coco as jcoco
from retinanet_tpu import eval_voc as jvoc
from retinanet_tpu import export as jexport
from retinanet_tpu.data.loaders.shapes import Shapes as JShapes
from retinanet_tpu.models.retinanet import RetinaNet as JRetinaNet
from retinanet_tpu_torch import eval_coco, eval_voc
from retinanet_tpu_torch.config import Config, ModelConfig
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import (export_model, flax_from_params,
                                        init_params, load_exported,
                                        params_from_flax)
from retinanet_tpu_torch.infer import Detector

from torch_parity import to_flax

torch.set_num_threads(2)

NAMES = ["square", "triangle", "circle"]


def assert_metrics_equal(got, want):
    """Same keys and the same values, nan where JAX has nan."""
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], dict):
            assert got[key] == want[key], key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def planted(seed, num_images=8, num_classes=3, crowd=False,
            difficult=False):
    """Per image: 0-4 GT boxes (pixels), each detected with a jittered box
    at a score drawn from a few levels (equal scores across images and
    classes), plus false positives and the odd missed GT; image 3 has no
    GT at all.  Crowd GTs carry ``iscrowd`` and an ``areas`` override;
    difficult GTs a ``difficult`` flag."""
    rng = np.random.RandomState(seed)
    dets, gts = [], []
    for i in range(num_images):
        n = 0 if i == 3 else rng.randint(1, 5)
        tl = rng.uniform(0, 150, (n, 2))
        size = rng.choice([12.0, 40.0, 110.0], (n, 1)) * rng.uniform(
            0.8, 1.25, (n, 2))
        gt_boxes = np.concatenate([tl, tl + size], 1).astype(np.float32)
        gt_cls = rng.randint(0, num_classes, n)
        gt = {"boxes": gt_boxes, "class_ids": gt_cls}
        if crowd:
            gt["iscrowd"] = rng.rand(n) < 0.25
            gt["areas"] = (size.prod(1) * rng.uniform(0.5, 1.0, n)).astype(
                np.float32)
        if difficult:
            gt["difficult"] = rng.rand(n) < 0.25
        hit = rng.rand(n) < 0.85
        jitter = rng.normal(0, 0.08, (n, 4)) * np.tile(size, 2)
        boxes = [(gt_boxes + jitter)[hit]]
        cls = [gt_cls[hit]]
        m = rng.randint(0, 6)
        fp_tl = rng.uniform(0, 200, (m, 2))
        boxes.append(np.concatenate(
            [fp_tl, fp_tl + rng.uniform(5, 80, (m, 2))], 1))
        cls.append(rng.randint(0, num_classes, m))
        scores = rng.choice([0.9, 0.7, 0.55, 0.3], hit.sum() + m)
        dets.append({"boxes": np.concatenate(boxes).astype(np.float32),
                     "scores": scores.astype(np.float32),
                     "class_ids": np.concatenate(cls)})
        gts.append(gt)
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("crowd", [False, True])
def test_coco_evaluator_equals_jax(seed, crowd):
    dets, gts = planted(seed, crowd=crowd)
    got = eval_coco.COCOEvaluator(3)
    want = jcoco.COCOEvaluator(3)
    small = eval_coco.COCOEvaluator(3, max_dets=(1, 2))
    j_small = jcoco.COCOEvaluator(3, max_dets=(1, 2))
    for det, gt in zip(dets, gts):
        for ev in (got, want, small, j_small):
            ev.add(det, gt)
    summary = want.summarize()
    assert 0 < summary["mAP"] < 1 and np.isfinite(summary["AR@100"])
    assert_metrics_equal(got.summarize(), summary)
    assert_metrics_equal(small.summarize(), j_small.summarize())
    np.testing.assert_array_equal(got.per_class_ap(), want.per_class_ap())
    assert_metrics_equal(eval_coco.evaluate_detections(dets, gts, 3),
                         jcoco.evaluate_detections(dets, gts, 3))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("difficult", [False, True])
def test_voc_evaluator_equals_jax(seed, difficult):
    dets, gts = planted(seed + 10, difficult=difficult)
    for thr in (0.5, 0.7):
        got = eval_voc.VOCEvaluator(3, thr)
        want = jvoc.VOCEvaluator(3, thr)
        for det, gt in zip(dets, gts):
            got.add(det, gt)
            want.add(det, gt)
        summary = want.summarize()
        assert 0 < summary["mAP_voc07"] < 1
        assert_metrics_equal(got.summarize(), summary)
        np.testing.assert_array_equal(got.per_class_ap(),
                                      want.per_class_ap())
    assert_metrics_equal(eval_voc.evaluate_detections_voc(dets, gts, 3),
                         jvoc.evaluate_detections_voc(dets, gts, 3))


def he_state_dict(config, seed):
    """The port's state_dict, every kernel He-scaled from numpy (the π
    prior's near-constant scores would make every detection a tie), γ≈1,
    β and biases small."""
    state = init_params(config, torch.Generator().manual_seed(0), 3)
    rng = np.random.RandomState(seed)
    out = {}
    for key, t in state.items():
        if key.endswith("kernel"):
            v = rng.randn(*t.shape) * np.sqrt(2.0 / np.prod(t.shape[1:]))
        elif key.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*t.shape)
        else:
            v = 0.1 * rng.randn(*t.shape)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


class _Mixed:
    """Shapes samples of two sizes, alternating, so that with buckets the
    batches are bucket-homogeneous and both end partial."""

    def __init__(self, cls):
        self.parts = [cls(None, 3, (64, 64), seed=1),
                      cls(None, 3, (48, 64), seed=2)]
        self.class_names = self.parts[0].class_names
        self.num_classes = len(self.class_names)

    def __iter__(self):
        for a, b in zip(*self.parts):
            yield a
            yield b


@pytest.fixture(scope="module")
def detector():
    """fp32 flagship at 64 px on the CPU, decode threshold 0.05."""
    config = Config(model=ModelConfig(backbone="resnet_50_dense",
                                      num_classes=3,
                                      compute_dtype="float32"))
    config = config.replace(
        data=dataclasses.replace(config.data, image_size=64, batch_size=4),
        nms=dataclasses.replace(config.nms, score_threshold=0.05))
    return Detector(config, he_state_dict(config, 4), NAMES, device="cpu")


@pytest.mark.parametrize("buckets,protocol", [
    (None, "coco"), (((64, 64), (48, 64)), "coco"), (None, "voc")])
def test_evaluate_model_equals_jax(detector, buckets, protocol):
    """The same Detector under both packages' ``evaluate_model``: one
    partial batch (zero-padded) per canvas, bucket-homogeneous batches,
    the score filter, the detections sink and per-class AP."""
    config = detector.config.replace(data=dataclasses.replace(
        detector.config.data, buckets=buckets))
    j_config = jcfg.Config(data=jcfg.DataConfig(
        image_size=64, batch_size=4, buckets=buckets))
    sinks = ([], [])
    kw = dict(score_threshold=0.06, protocol=protocol, per_class=True)
    got = eval_coco.evaluate_model(
        detector, _Mixed(Shapes), config,
        detections_sink=lambda gt, det: sinks[0].append((gt, det)), **kw)
    want = jcoco.evaluate_model(
        detector, _Mixed(JShapes), j_config,
        detections_sink=lambda gt, det: sinks[1].append((gt, det)), **kw)
    assert_metrics_equal(got, want)
    assert len(sinks[0]) == len(sinks[1]) == 6
    for (g_gt, g_det), (w_gt, w_det) in zip(*sinks):
        assert g_gt["image_id"] == w_gt["image_id"]
        for key in w_det:
            np.testing.assert_array_equal(g_det[key], w_det[key])
    assert sum(len(d["scores"]) for _, d in sinks[0]) > 0
    capped = eval_coco.evaluate_model(detector, _Mixed(Shapes), config,
                                      max_images=2)
    assert_metrics_equal(capped, jcoco.evaluate_model(
        detector, _Mixed(JShapes), j_config, max_images=2))


def test_evaluate_model_refuses_shards(detector):
    """Shards without their ranks: one process holding shard 0 of 2 would
    score half the set as if it were all of it."""
    with pytest.raises(ValueError, match="2 ranks"):
        eval_coco.evaluate_model(detector, _Mixed(Shapes), detector.config,
                                 process_shard=(0, 2))


# JAX model templates by module repr: ``load_exported`` builds its template
# with ``init``, which runs the whole model eagerly (~40 s here); the tests
# trace it with ``eval_shape`` instead, once.
_TEMPLATES = {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_model_writes_the_jax_format(tmp_path, monkeypatch, dtype):
    """The port's writer and JAX's on the same parameters: the same leaf
    names, dtypes and bits, the same meta record; JAX's ``load_exported``
    reads the port's file (checking every leaf's path and shape against
    the JAX model) into the values of JAX's own file, and the port's
    ``load_exported`` back into the written state_dict (bf16 storage: its
    rounding)."""
    config = Config(model=ModelConfig(backbone="resnet_50_dense",
                                      num_classes=3))
    state = init_params(config, torch.Generator().manual_seed(7), 3)
    flat = flax_from_params(state)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax.npz")
    assert export_model(state, NAMES, "resnet_50_dense", 64, ours,
                        dtype=dtype) == len(state)
    jexport.export_model(to_flax(flat), NAMES, "resnet_50_dense", 64,
                         theirs, dtype=dtype)
    with np.load(ours + ".npz") as got, np.load(theirs) as want:
        assert list(got.files) == list(want.files)
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            assert got[name].tobytes() == want[name].tobytes(), name
        stored = {name: want[name] for name in want.files}
    assert jexport.read_meta(ours + ".npz") == jexport.read_meta(theirs)

    init = JRetinaNet.init

    def abstract_init(self, *args, **kw):
        key = repr(self)
        if key not in _TEMPLATES:
            _TEMPLATES[key] = jax.eval_shape(lambda: init(self, *args, **kw))
        return _TEMPLATES[key]

    monkeypatch.setattr(JRetinaNet, "init", abstract_init)
    meta, params, names, size = jexport.load_exported(ours + ".npz")
    assert (names, size, meta["dtype"]) == (NAMES, 64, dtype)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(state)
    for path, leaf in leaves:
        want = stored[jexport._leaf_path(path)]
        if dtype == "bfloat16":
            want = jnp.asarray(want.view(jnp.bfloat16)).astype(jnp.float32)
        assert leaf.dtype == jnp.float32
        assert np.asarray(leaf).tobytes() == np.asarray(want).tobytes()

    _, back, _, _ = load_exported(ours + ".npz")
    for key, t in state.items():
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16).float()
        assert torch.equal(back[key], t), key
    assert params_from_flax(flat).keys() == state.keys()
