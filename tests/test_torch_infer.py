"""``retinanet_tpu_torch.infer.Detector`` end to end on the CPU against JAX
``make_inference_fn`` in fp32, on the same numpy-seeded weights and
images: normalize → flagship forward → fused decode + classwise NMS."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinanet_tpu.config import Config
from retinanet_tpu.export import export_model
from retinanet_tpu.infer import Detector as JaxDetector
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.infer import Detector, benchmark

from torch_parity import flagship_config, random_flat_params, to_flax

torch.set_num_threads(2)


def _assert_same_detections(got, want):
    """Per image: the same number of valid detections, and each JAX one
    has a port one of the same class with score ≤1e-5 and box coordinates
    ≤1e-4·(1+|coord|) away.  fp32 outputs differ by ~1e-5 relative after
    ~70 layers summed in another order (measured ≤5e-6 on scores, ≤1.2e-5
    relative on boxes, which exp(log-scale) stretches to ±20 under random
    weights), so detections whose scores are that close may swap ranks."""
    for i in range(want.valid.shape[0]):
        wv, gv = np.asarray(want.valid[i]), got.valid[i].numpy()
        assert wv.sum() == gv.sum() > 0
        w_cls = np.asarray(want.class_ids[i])[wv]
        w_sc = np.asarray(want.scores[i])[wv]
        w_box = np.asarray(want.boxes[i])[wv]
        g_cls = got.class_ids[i].numpy()[gv]
        g_sc = got.scores[i].numpy()[gv]
        g_box = got.boxes[i].numpy()[gv]
        match = ((w_cls[:, None] == g_cls[None])
                 & (np.abs(w_sc[:, None] - g_sc[None]) <= 1e-5)
                 & (np.abs(w_box[:, None] - g_box[None])
                    <= 1e-4 * (1 + np.abs(w_box[:, None]))).all(-1))
        assert match.any(1).all() and match.any(0).all(), i


def test_detector_matches_jax_fp32():
    config = Config(model=flagship_config(compute_dtype="float32"))
    config = config.replace(data=dataclasses.replace(config.data,
                                                     image_size=64))
    flat = random_flat_params(config.model, seed=2)
    names = ["a", "b", "c", "d"]
    images = (np.random.RandomState(3).rand(2, 64, 64, 3) * 255).astype(
        np.uint8)

    want = JaxDetector(config, to_flax(flat), names)(jnp.asarray(images))
    detector = Detector(config, params_from_flax(flat), names, device="cpu")
    got = detector(images)
    valid = np.asarray(want.valid)
    assert valid.sum() < valid.size
    _assert_same_detections(got, want)

    dets = detector.detect(images)
    assert len(dets) == 2
    assert [len(d["scores"]) for d in dets] == list(valid.sum(1))


def test_detector_from_export(tmp_path):
    """A JAX export file serves through ``Detector.from_export``: backbone,
    classes and canvas come from the file, and detections equal those of
    a Detector built from the same weights directly."""
    flat = random_flat_params(flagship_config(), seed=4)
    path = str(tmp_path / "m.npz")
    names = ["a", "b", "c", "d"]
    export_model(to_flax(flat), names, "resnet_50_dense", 64, path)
    detector = Detector.from_export(path, device="cpu")
    assert detector.class_names == names
    assert detector.config.model.backbone == "resnet_50_dense"
    assert detector.config.data.image_size == 64
    direct = Detector(detector.config, params_from_flax(flat), names,
                      device="cpu")
    images = (np.random.RandomState(5).rand(1, 64, 64, 3) * 255).astype(
        np.uint8)
    for got, want in zip(detector(images), direct(images)):
        assert torch.equal(got, want)


def test_benchmark_refuses_cpu():
    with pytest.raises(RuntimeError, match="card"):
        benchmark(Config(), device="cpu")


def test_entry_points_default_to_the_card():
    """``Detector``, ``Detector.from_export`` and the benchmarks run on the
    card unless the caller passes another device."""
    import inspect

    from retinanet_tpu_torch.train import benchmark_train
    for fn in (Detector.__init__, Detector.from_export, benchmark,
               benchmark_train):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
