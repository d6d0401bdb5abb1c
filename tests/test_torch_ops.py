"""Port ops (retinanet_tpu_torch.ops) against the JAX package on the CPU:
box geometry, normalization, the group policy, greedy NMS and the fused
decode + NMS serving path, on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retinanet_tpu.config import DataConfig, NMSConfig
from retinanet_tpu.models.layers import resolve_groups as jax_resolve_groups
from retinanet_tpu.ops import boxes as jbox
from retinanet_tpu.ops import nms as jnms
from retinanet_tpu.ops.anchors import build_levels
from retinanet_tpu.ops.preprocess import maybe_normalize as jax_normalize
from retinanet_tpu_torch.models.layers import resolve_groups
from retinanet_tpu_torch.ops import boxes as tbox
from retinanet_tpu_torch.ops import nms as tnms
from retinanet_tpu_torch.ops.preprocess import maybe_normalize

torch.set_num_threads(2)


def _boxes(rng, shape):
    centers = rng.rand(*shape, 2) * 0.8 + 0.1
    sizes = rng.rand(*shape, 2) * 0.25 + 0.05
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          -1).astype(np.float32)


def test_boxes_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, (40,)), _boxes(rng, (30,))
    center = rng.rand(5, 7, 4).astype(np.float32)
    # ≤1e-6: the same fp32 ops in the same order.
    np.testing.assert_allclose(
        tbox.from_center_box(torch.from_numpy(center)).numpy(),
        np.asarray(jbox.from_center_box(jnp.asarray(center))), atol=1e-6)
    np.testing.assert_allclose(
        tbox.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)
    np.testing.assert_allclose(
        tbox.iou(torch.from_numpy(a[:30]), torch.from_numpy(b)).numpy(),
        np.asarray(jbox.iou(jnp.asarray(a[:30]), jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_maybe_normalize_matches_jax(dtype):
    rng = np.random.RandomState(1)
    img = (rng.rand(2, 8, 6, 3) * 255).astype(dtype)
    got = maybe_normalize(torch.from_numpy(img), DataConfig()).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(img), DataConfig()))
    np.testing.assert_allclose(got, want, atol=1e-6)  # ≤1e-6, fp32 ops


def test_resolve_groups_equals_jax():
    assert all(resolve_groups(c) == jax_resolve_groups(c)
               for c in range(1, 2049))


def test_greedy_keep_mask_equals_jax():
    """The plain keep mask equals JAX ``_greedy_keep_mask`` exactly on the
    clustered boxes of ``tests/test_nms.py``; the CPU wrapper is it."""
    rng = np.random.RandomState(7)
    bsz, n = 3, 150
    boxes = _boxes(rng, (bsz, n))
    scores = -np.sort(-rng.rand(bsz, n).astype(np.float32), axis=1)
    want = np.stack([np.asarray(jnms._greedy_keep_mask(
        jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5))
        for i in range(bsz)])
    got = tnms._greedy_keep_mask(torch.from_numpy(boxes), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size  # suppression happened
    np.testing.assert_array_equal(
        tnms.nms_keep_mask_batch(torch.from_numpy(boxes), 0.5).numpy(), want)
    np.testing.assert_array_equal(
        tnms.nms_keep_mask(torch.from_numpy(boxes[1]), 0.5).numpy(), want[1])


def test_sigmoid_close_to_jax_over_bf16():
    """Scores are sigmoid(logit).  Over all 65280 finite bf16 logits the
    two libraries differ on 17 (measured): by ≤2 float32 ulp where the
    result is a normal float, and below -87 XLA's CPU flushes the
    subnormal result to 0 where torch keeps it.  So scores agree bitwise
    only on logits off that set (the decode test's grid is)."""
    u = np.arange(65536, dtype=np.uint16)
    x = u.view(ml_dtypes.bfloat16).astype(np.float32)
    x = x[np.isfinite(x)]
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = torch.sigmoid(torch.from_numpy(x)).numpy()
    assert (got != want).sum() <= 17
    normal = want >= np.finfo(np.float32).tiny
    np.testing.assert_array_max_ulp(got[normal], want[normal], maxulp=2)
    np.testing.assert_allclose(got[~normal], want[~normal], atol=1e-37)


def _level_maps(rng, size, num_classes, dtype):
    """Logits on a 1/8 grid in [-5, 5): many exact ties across anchors and
    classes.  The grid holds none of the bf16 values where the two sigmoids
    differ (test above), so scores can be compared exactly."""
    levels = build_levels()
    cls, reg = {}, {}
    for pn in levels:
        gh, gw = levels.grid_hw(pn, size)
        logits = rng.randint(-40, 40, (2, gh, gw, 9, num_classes)) / 8.0
        cls[pn] = logits.astype(dtype)
        reg[pn] = (rng.randn(2, gh, gw, 9, 4) * 0.2).astype(dtype)
    return levels, cls, reg


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_fused_decode_nms_matches_jax(dtype):
    """Identical logits and regressions at a 64-px canvas with 4 classes:
    valid mask, class ids and scores exact; boxes ≤1e-6 (exp differs by an
    ulp between the two libraries)."""
    rng = np.random.RandomState(3)
    levels, cls, reg = _level_maps(rng, 64, 4, dtype)
    cfg = NMSConfig(score_threshold=0.05, top_k_per_level=100,
                    pre_nms_top_k=200, max_output_size=200)
    want = jax.jit(lambda c, r: jnms.fused_decode_nms(c, r, levels, 64, cfg))(
        {k: jnp.asarray(v) for k, v in cls.items()},
        {k: jnp.asarray(v) for k, v in reg.items()})

    def torch_maps(maps):
        if dtype == np.float32:
            return {k: torch.from_numpy(v) for k, v in maps.items()}
        return {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                for k, v in maps.items()}

    got = tnms.fused_decode_nms(torch_maps(cls), torch_maps(reg), levels, 64,
                                cfg)
    valid = np.asarray(want.valid)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.class_ids.numpy(),
                                  np.asarray(want.class_ids))
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-6)
