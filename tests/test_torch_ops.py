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


def test_box_encoding_matches_jax():
    """``to_center_box``, ``position_grid``, ``encode_boxes`` and
    ``regression_postprocess``: ≤1e-6 absolute (the same fp32 ops; exp and
    log may differ by an ulp between the libraries)."""
    rng = np.random.RandomState(11)
    corners = _boxes(rng, (6, 5))
    np.testing.assert_allclose(
        tbox.to_center_box(torch.from_numpy(corners)).numpy(),
        np.asarray(jbox.to_center_box(jnp.asarray(corners))), atol=1e-6)
    np.testing.assert_array_equal(
        tbox.position_grid(5, 7).numpy(),
        np.asarray(jbox.position_grid(5, 7)))
    center = jbox.to_center_box(jnp.asarray(corners))
    pos = rng.rand(6, 5, 2).astype(np.float32)
    size = rng.rand(6, 5, 2).astype(np.float32) * 0.5 + 0.1
    np.testing.assert_allclose(
        tbox.encode_boxes(torch.from_numpy(np.asarray(center)),
                          torch.from_numpy(pos), torch.from_numpy(size)
                          ).numpy(),
        np.asarray(jbox.encode_boxes(center, jnp.asarray(pos),
                                     jnp.asarray(size))), atol=1e-6)
    regr = (rng.randn(2, 4, 3, 9, 4) * 0.3).astype(np.float32)
    sizes = rng.rand(9, 2).astype(np.float32) * 0.3 + 0.05
    np.testing.assert_allclose(
        tbox.regression_postprocess(torch.from_numpy(regr),
                                    torch.from_numpy(sizes)).numpy(),
        np.asarray(jbox.regression_postprocess(jnp.asarray(regr),
                                               jnp.asarray(sizes))),
        atol=1e-6)


def _gt_batch(rng, bsz=2, max_boxes=12, num_classes=4):
    """Padded GT: 1-5 valid boxes per image of random classes; padded rows
    are zero boxes with class 0 (as the pipeline pads)."""
    boxes = np.zeros((bsz, max_boxes, 4), np.float32)
    ids = np.zeros((bsz, max_boxes), np.int32)
    mask = np.zeros((bsz, max_boxes), bool)
    for i in range(bsz):
        n = rng.randint(1, 6)
        tl = rng.rand(n, 2) * 0.5
        boxes[i, :n] = np.concatenate([tl, tl + 0.1 + rng.rand(n, 2) * 0.4],
                                      -1)
        ids[i, :n] = rng.randint(0, num_classes, n)
        mask[i, :n] = True
    boxes[1, 2] = boxes[1, 0]  # a duplicate box: the argmax tie
    ids[1, 2] = (ids[1, 0] + 1) % num_classes
    return boxes, ids, mask


@pytest.mark.parametrize("chunk,bg_pos", [(0, True), (5, True), (0, False)],
                         ids=["dense", "chunked", "paper-bg"])
def test_assignment_labels_equal_jax(chunk, bg_pos):
    """``build_labels_batch`` at 64 px: classification and trainable masks
    exactly equal, ties picking the lowest box index (a duplicate box of
    another class is in the batch; the gather returns the rows JAX's
    HIGHEST-precision one-hot matmul reproduces bit for bit).  Regression
    targets within 5e-7 relative or absolute (measured ≤2.4e-7 absolute,
    1-2 ulp): under jit XLA turns the division by the constant anchor sizes
    into a multiplication by their reciprocal, and its log differs from
    torch's by an ulp on ~12% of inputs."""
    from retinanet_tpu.config import AssignConfig as JaxAssign
    from retinanet_tpu.ops.assign import build_labels_batch as jax_labels
    from retinanet_tpu_torch.config import AssignConfig
    from retinanet_tpu_torch.ops import anchors as tanchors
    from retinanet_tpu_torch.ops.assign import build_labels_batch

    rng = np.random.RandomState(12)
    boxes, ids, mask = _gt_batch(rng)
    want = jax.jit(lambda b, i, m: jax_labels(
        b, i, m, 64, build_levels(), 4,
        JaxAssign(match_chunk=chunk, bg_uses_pos_threshold=bg_pos)))(
        jnp.asarray(boxes), jnp.asarray(ids), jnp.asarray(mask))
    got = build_labels_batch(
        torch.from_numpy(boxes), torch.from_numpy(ids),
        torch.from_numpy(mask), 64, tanchors.build_levels(), 4,
        AssignConfig(match_chunk=chunk, bg_uses_pos_threshold=bg_pos))
    for kind, w, g in zip(("class", "regr", "mask"), want, got):
        assert list(g) == list(w)
        for pn in w:
            if kind == "regr":
                np.testing.assert_allclose(g[pn].numpy(), np.asarray(w[pn]),
                                           rtol=5e-7, atol=5e-7, err_msg=pn)
            else:
                np.testing.assert_array_equal(g[pn].numpy(),
                                              np.asarray(w[pn]), err_msg=pn)
    fg = sum(int(np.asarray(w).sum()) for w in want[0].values())
    assert fg > 0


def _loss_inputs(rng, n=300, c=4):
    labels = np.zeros((2, n, c), np.float32)
    fg = rng.rand(2, n) < 0.1
    labels[fg, rng.randint(0, c, fg.sum())] = 1.0
    logits = (rng.randn(2, n, c) * 2).astype(np.float32)
    weights = rng.rand(2, n) < 0.8
    regr_t = rng.randn(2, n, 4).astype(np.float32)
    regr_p = (regr_t + rng.randn(2, n, 4) * 1.5).astype(np.float32)
    return labels, logits, weights, regr_t, regr_p, fg & weights


def test_losses_match_jax():
    """Each class loss, Huber, the regression loss and ``detection_loss``
    on shared logits: ≤1e-6 relative (fp32 sums in another order)."""
    from retinanet_tpu.config import LossConfig as JaxLoss
    from retinanet_tpu.ops import losses as jl
    from retinanet_tpu_torch.config import LossConfig
    from retinanet_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(13)
    labels, logits, weights, regr_t, regr_p, fg = _loss_inputs(rng)
    t = lambda a: torch.from_numpy(a)
    j = jnp.asarray
    wf = weights.astype(np.float32)
    pairs = {
        "dice": (tl.dice_loss_masked(t(labels), t(logits), t(wf)),
                 jl.dice_loss_masked(j(labels), j(logits), j(wf))),
        "jaccard": (tl.jaccard_loss_masked(t(labels), t(logits), t(wf)),
                    jl.jaccard_loss_masked(j(labels), j(logits), j(wf))),
        "fixed_iou": (tl.fixed_iou_loss_masked(t(labels), t(logits), t(wf)),
                      jl.fixed_iou_loss_masked(j(labels), j(logits), j(wf))),
        "balanced_bce": (tl.balanced_bce_masked(t(labels), t(logits), t(wf)),
                         jl.balanced_bce_masked(j(labels), j(logits),
                                                j(wf))),
        "regression": (tl.regression_loss(t(regr_t), t(regr_p), t(fg)),
                       jl.regression_loss(j(regr_t), j(regr_p), j(fg))),
    }
    for name in ("bce", "focal", "dice", "jaccard", "fixed_iou",
                 "balanced_bce"):
        pairs[f"class:{name}"] = (
            tl.classification_loss(t(labels), t(logits), t(weights), t(fg),
                                   LossConfig(class_losses=(name,))),
            jl.classification_loss(j(labels), j(logits), j(weights), j(fg),
                                   JaxLoss(class_losses=(name,))))
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        tl.huber_loss(t(regr_t), t(regr_p)).numpy(),
        np.asarray(jl.huber_loss(j(regr_t), j(regr_p))), rtol=1e-6)
    got = tl.detection_loss(t(labels), t(logits), t(regr_t), t(regr_p),
                            t(weights), LossConfig())
    want = jl.detection_loss(j(labels), j(logits), j(regr_t), j(regr_p),
                             j(weights), JaxLoss())
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown"):
        tl.classification_loss(t(labels), t(logits), t(weights), t(fg),
                               LossConfig(class_losses=("nope",)))


def test_flatten_levels_and_histograms_match_jax():
    """``flatten_levels`` exact on maps and masks; ``prob_histograms``
    exact counts."""
    from retinanet_tpu.utils.pytree import flatten_levels as jflat
    from retinanet_tpu.utils.summaries import prob_histograms as jhist
    from retinanet_tpu_torch.utils.pytree import flatten_levels
    from retinanet_tpu_torch.utils.summaries import prob_histograms

    rng = np.random.RandomState(14)
    maps = {pn: rng.rand(2, s, s, 9, 4).astype(np.float32)
            for pn, s in (("P4", 4), ("P3", 8), ("P5", 2))}
    masks = {pn: m[..., 0] > 0.5 for pn, m in maps.items()}
    for d in (maps, masks):
        np.testing.assert_array_equal(
            flatten_levels({k: torch.from_numpy(v) for k, v in d.items()}
                           ).numpy(),
            np.asarray(jflat({k: jnp.asarray(v) for k, v in d.items()})))
    labels, logits, weights, *_ = _loss_inputs(rng)
    probs = 1 / (1 + np.exp(-logits))
    got = prob_histograms(torch.from_numpy(labels), torch.from_numpy(probs),
                          torch.from_numpy(weights))
    want = jhist(jnp.asarray(labels), jnp.asarray(probs),
                 jnp.asarray(weights))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
