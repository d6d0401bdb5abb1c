"""The port's reference decode path (``ops/nms.py``: ``classmap_decode``,
``decode_level``, ``decode_levels``, ``nms_padded``) and its FLOP count
(``infer.forward_gflops_per_image``) against the JAX package on the CPU,
on the same numpy-seeded inputs.  Bounds, as
``test_torch_ops.py::test_fused_decode_nms_matches_jax`` states them:
class ids, validity and order exact; scores exact (logits on a 1/8 grid,
where the two sigmoids agree bitwise); boxes ≤1e-6 (``exp`` may differ by
an ulp between the libraries)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.config import NMSConfig
from retinanet_tpu.infer import forward_gflops_per_image as jax_gflops
from retinanet_tpu.ops import nms as jnms
from retinanet_tpu.ops.anchors import build_levels
from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.infer import forward_gflops_per_image
from retinanet_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)
# Between the two largest grid logits' sigmoids (4.75 and 4.875): a few
# percent of the anchors pass.
THRESHOLD = 0.992


def _maps(rng, size, num_classes, dtype):
    """Per-level logits on a 1/8 grid in [-5, 5) (exact ties across
    anchors and classes) and regressions, as numpy arrays of ``dtype``."""
    levels = build_levels()
    cls, reg = {}, {}
    for pn in levels:
        gh, gw = levels.grid_hw(pn, size)
        cls[pn] = (rng.randint(-40, 40, (2, gh, gw, 9, num_classes)) / 8.0
                   ).astype(dtype)
        reg[pn] = (rng.randn(2, gh, gw, 9, 4) * 0.2).astype(dtype)
    return levels, cls, reg


def _torch(a):
    """A numpy array (bf16 through its bits) as a torch tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_same(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.class_ids.numpy(),
                                  np.asarray(want.class_ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-6)


def test_classmap_decode_matches_jax():
    rng = np.random.RandomState(0)
    probs = (rng.randint(0, 9, (2, 5, 6, 9, 4)) / 8.0).astype(np.float32)
    for thr in (0.5, 0.75):
        np.testing.assert_array_equal(
            tnms.classmap_decode(torch.from_numpy(probs), thr).numpy(),
            np.asarray(jnms.classmap_decode(jnp.asarray(probs), thr)))


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_decode_level_matches_jax(dtype, approx):
    """One level (P3 at 64 px, 576 anchors, top 100): the bf16 logits take
    the packed-key path, fp32 the max-then-gather path; ``approx`` is
    exact in both packages on the CPU."""
    rng = np.random.RandomState(1)
    levels, cls, reg = _maps(rng, 64, 5, dtype)
    sizes = levels.normalized_anchor_sizes("P3", 64)
    want = jax.jit(lambda c, r: jnms.decode_level(
        c, r, jnp.asarray(sizes), 100, THRESHOLD, approx=approx))(
            jnp.asarray(cls["P3"]), jnp.asarray(reg["P3"]))
    got = tnms.decode_level(_torch(cls["P3"]), _torch(reg["P3"]),
                            torch.from_numpy(sizes), 100, THRESHOLD,
                            approx=approx)
    assert got.boxes.shape == (2, 100, 4)
    assert 0 < np.asarray(want.valid).sum() < 200
    _assert_same(got, want)


def test_decode_levels_matches_jax():
    """All five levels at 64 px; P5, P6 and P7 hold fewer anchors than
    ``top_k_per_level`` (36, 9 and 9 of 50)."""
    rng = np.random.RandomState(2)
    levels, cls, reg = _maps(rng, 64, 4, ml_dtypes.bfloat16)
    cfg = NMSConfig(top_k_per_level=50, score_threshold=THRESHOLD)
    want = jax.jit(lambda c, r: jnms.decode_levels(c, r, levels, 64, cfg))(
        {k: jnp.asarray(v) for k, v in cls.items()},
        {k: jnp.asarray(v) for k, v in reg.items()})
    got = tnms.decode_levels({k: _torch(v) for k, v in cls.items()},
                             {k: _torch(v) for k, v in reg.items()},
                             levels, 64, cfg)
    assert got.scores.shape == (2, 50 * 2 + 36 + 9 + 9)
    _assert_same(got, want)


@pytest.mark.parametrize("pre_nms_top_k", [None, 150],
                         ids=["all", "top150"])
@pytest.mark.parametrize("classwise", [True, False],
                         ids=["classwise", "agnostic"])
def test_nms_padded_matches_jax(classwise, pre_nms_top_k):
    """Clustered boxes of 4 classes, scores on a 1/64 grid (ties, which
    both order by lower index first), a fifth of the candidates invalid,
    at most 60 outputs of 240 candidates."""
    rng = np.random.RandomState(3)
    b, n = 2, 240
    centers = rng.rand(b, n, 2) * 0.6 + 0.2
    sizes = rng.rand(b, n, 2) * 0.3 + 0.05
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           -1).astype(np.float32)
    scores = (rng.randint(1, 64, (b, n)) / 64.0).astype(np.float32)
    ids = rng.randint(0, 4, (b, n)).astype(np.int32)
    valid = rng.rand(b, n) > 0.2
    args = dict(iou_threshold=0.5, max_output_size=60, classwise=classwise,
                pre_nms_top_k=pre_nms_top_k)
    want = jax.jit(lambda *a: jnms.nms_padded(jnms.BoxesDecoded(*a),
                                              use_pallas=False, **args))(
        boxes, scores, ids, valid)
    got = tnms.nms_padded(tnms.BoxesDecoded(*map(torch.from_numpy, (
        boxes, scores, ids, valid))), **args)
    assert got.boxes.shape == (b, 60, 4)
    assert np.asarray(want.valid).sum() > 0
    _assert_same(got, want)
    np.testing.assert_array_equal(got.scores.numpy()[~got.valid.numpy()], 0)


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_reference_path_equals_fused_decode_nms(dtype):
    """The port's ``nms_padded(decode_levels(...))`` at the shared pre-NMS
    cap equals its ``fused_decode_nms`` (as ``tests/test_nms.py`` holds
    JAX's): valid, ids and scores exactly, boxes ≤1e-6.  The cap (30)
    drops valid candidates (~45 an image pass the threshold)."""
    rng = np.random.RandomState(4)
    levels, cls, reg = _maps(rng, 64, 5, dtype)
    cfg = NMSConfig(top_k_per_level=50, pre_nms_top_k=30, max_output_size=40,
                    score_threshold=THRESHOLD)
    cls_t = {k: _torch(v) for k, v in cls.items()}
    reg_t = {k: _torch(v) for k, v in reg.items()}
    ref = tnms.nms_padded(tnms.decode_levels(cls_t, reg_t, levels, 64, cfg),
                          iou_threshold=cfg.iou_threshold,
                          max_output_size=cfg.max_output_size,
                          pre_nms_top_k=cfg.pre_nms_top_k)
    got = tnms.fused_decode_nms(cls_t, reg_t, levels, 64, cfg)
    assert 0 < int(ref.valid.sum()) < ref.valid.numel()
    _assert_same(got, ref)


@pytest.mark.parametrize("size", [64, 640])
def test_forward_gflops_matches_jax(size):
    """The FLOP count of the dense flagship equals JAX's jaxpr count
    (190.2252544 GFLOP per image at 640 px) to 1e-9 relative."""
    want = jax_gflops(JaxConfig().replace(
        model=dataclasses.replace(JaxConfig().model,
                                  backbone="resnet_50_dense"),
        data=dataclasses.replace(JaxConfig().data, image_size=size)))
    config = Config()
    got = forward_gflops_per_image(config.replace(
        model=dataclasses.replace(config.model, backbone="resnet_50_dense",
                                  fused_blocks=True, fused_res2=True),
        data=dataclasses.replace(config.data, image_size=size)))
    assert got == pytest.approx(want, rel=1e-9)
    if size == 640:
        assert got == pytest.approx(190.2252544, rel=1e-9)
