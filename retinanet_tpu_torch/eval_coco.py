"""COCO-style mAP evaluation (a copy of ``retinanet_tpu/eval_coco.py``) — a
capability the reference entirely lacks (its ``model_fn`` is TRAIN-only,
its ``train.py:207``), but the north-star target demands mAP parity
measurement (BASELINE.md).

Self-contained numpy implementation of the COCO detection metric protocol
(pycocotools is not available in this environment), matching pycocotools'
``COCOeval`` bbox semantics detail-for-detail:

  * detections sorted by descending score (stable), truncated to ``maxDets``
    per image **per category** (COCOeval ``evaluateImg`` with useCats=1)
  * greedy matching in score order; each detection takes the best-IoU
    still-unmatched GT with IoU ≥ threshold, ties going to the **later** GT
    (COCOeval uses strict ``<`` when scanning, so an equal IoU updates the
    match) — ``cocoeval.py evaluateImg``
  * GT/detection ignore flags from area ranges: ignored GTs don't count
    toward recall, detections matched to ignored GTs (or unmatched with
    out-of-range area) are neither TP nor FP — ``cocoeval.py accumulate``
  * 101-point interpolated precision: monotone envelope then
    ``searchsorted(recall, recThrs, side='left')`` — ``cocoeval.py:507-512``
  * AP averaged over IoU thresholds .50:.05:.95, mean over classes with ≥1
    non-ignored GT; AR (max recall) at maxDets 1/10/100

  * crowd GTs (``iscrowd``) are ignore *regions*: matched by intersection-
    over-detection-area, multi-matchable, never counted toward recall —
    ``cocoeval.py evaluateImg`` iscrowd branches
  * area-range ignores read the annotation ``area`` (segmentation area on
    real COCO) when provided, falling back to bbox area
  * annotation-free images participate (the eval-mode COCO loader yields
    them with empty GT arrays): detections on them are false positives,
    exactly as pycocotools scores every image in ``ann['images']``

Validated two ways: hand-derived traces of the pycocotools algorithm
(``tests/test_eval.py``) and an *independent* cocoeval.py transliteration
property-tested to 1e-9 agreement over 1200+ randomized images with score
ties, IoU-at-threshold ties, crowds, area overrides and maxDets truncation
(``tests/test_eval_reference_matcher.py``).

``COCOEvaluator`` is streaming: per-image matching happens in ``add`` and
memory is O(total detections), not O(dataset) — images are never retained.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Exactly pycocotools Params: linspace, NOT arange — arange's accumulated
# fp error (0.6000000000000001) flips matches whose IoU is exactly at a
# threshold.
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# COCOeval areaRng: all / small / medium / large (cocoeval.py Params).
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _intersection_and_areas(a: np.ndarray, b: np.ndarray):
    """Shared geometry for IoU/IoF: ([N,M] intersection, [N] area_a,
    [M] area_b) in float64 (pycocotools computes in double; float32
    rounding at an exact-threshold IoU, e.g. 0.6, flips matches)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    t = np.maximum(a[:, None, 0], b[None, :, 0])
    l = np.maximum(a[:, None, 1], b[None, :, 1])
    bb = np.minimum(a[:, None, 2], b[None, :, 2])
    r = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(bb - t, 0, None) * np.clip(r - l, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter, area_a, area_b


def _box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] × [M,4] (t,l,b,r) → [N,M] IoU (float64)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    inter, area_a, area_b = _intersection_and_areas(a, b)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _box_iof_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] × [M,4] (t,l,b,r) → [N,M] intersection over the area of ``a``
    (the detection) — COCOeval's crowd-GT "IoU" (``maskUtils.iou`` with
    ``iscrowd=1``)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    inter, area_a, _ = _intersection_and_areas(a, b)
    return np.where(area_a[:, None] > 0,
                    inter / np.maximum(area_a[:, None], 1e-12), 0.0)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0, np.float32)
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _match_image(det_boxes: np.ndarray, det_scores: np.ndarray,
                 gt_boxes: np.ndarray, iou_threshold: float,
                 gt_ignore: Optional[np.ndarray] = None,
                 area_range: Tuple[float, float] = (0.0, 1e10),
                 gt_crowd: Optional[np.ndarray] = None):
    """COCOeval ``evaluateImg`` for one (image, category, threshold).

    Returns (scores, tp, det_ignore) aligned in descending-score order.
    GTs are scanned non-ignored first (COCOeval sorts by ``_ignore``); a
    detection takes the best still-unmatched GT, where "best" uses strict
    ``<`` — equal IoU moves the match to the later GT.  A real (non-ignored)
    match stops the scan before ignored GTs (``cocoeval.py`` ``break``).

    Crowd GTs (``gt_crowd``) follow COCOeval's crowd protocol exactly:
    they are always ignore regions (``_prepare`` sets ``_ignore = iscrowd``,
    so callers must include crowds in ``gt_ignore``), their "IoU" is
    intersection over *detection* area (``maskUtils.iou``'s iscrowd flag),
    and — unlike ordinary GTs — a crowd GT stays matchable after being
    matched (``evaluateImg``: ``if gtm[...] > 0 and not iscrowd[gind]:
    continue``), so one crowd region can absorb many detections.
    """
    order = np.argsort(-det_scores, kind="stable")
    det_boxes, det_scores = det_boxes[order], det_scores[order]
    if gt_ignore is None:
        gt_ignore = np.zeros(len(gt_boxes), bool)
    if gt_crowd is None:
        gt_crowd = np.zeros(len(gt_boxes), bool)
    # COCOeval sorts GT so ignored ones come last (stable).
    gt_order = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_ignore, gt_crowd = gt_ignore[gt_order], gt_crowd[gt_order]

    if len(det_boxes) and len(gt_boxes):
        inter, area_d, area_g = _intersection_and_areas(det_boxes, gt_boxes)
        union = area_d[:, None] + area_g[None, :] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        if gt_crowd.any():
            # Crowd columns use intersection-over-detection-area.
            iof = np.where(area_d[:, None] > 0,
                           inter / np.maximum(area_d[:, None], 1e-12), 0.0)
            iou = np.where(gt_crowd[None, :], iof, iou)
    else:
        iou = np.zeros((len(det_boxes), len(gt_boxes)))
    gt_used = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(det_boxes), bool)
    det_ig = np.zeros(len(det_boxes), bool)
    thr = min(iou_threshold, 1 - 1e-10)
    for d in range(len(det_boxes)):
        best, m = thr, -1
        for g in range(len(gt_boxes)):
            if gt_used[g] and not gt_crowd[g]:
                continue
            # A real match stops the scan once only ignored GTs remain.
            if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                break
            if iou[d, g] < best:
                continue
            best, m = iou[d, g], g
        if m > -1:
            gt_used[m] = True
            det_ig[d] = gt_ignore[m]
            tp[d] = not gt_ignore[m]
    # Unmatched detections with out-of-range area are ignored (not FP).
    area = _box_area(det_boxes)
    out_of_range = (area < area_range[0]) | (area > area_range[1])
    det_ig |= (~tp) & (~det_ig) & out_of_range
    return det_scores, tp, det_ig


def _average_precision(scores, tp, det_ig, num_gt) -> Tuple[float, float]:
    """(AP, max recall) from pooled (score, tp, ignore) across images —
    COCOeval ``accumulate`` for one (category, threshold, area, maxDets)."""
    if num_gt == 0:
        return np.nan, np.nan
    keep = ~det_ig
    scores, tp = scores[keep], tp[keep]
    if len(scores) == 0:
        return 0.0, 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # Monotone non-increasing precision envelope.
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # Interpolate at the 101 recall points (cocoeval.py searchsorted left;
    # indices past the end read as 0).
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    interp = np.where(idx < len(precision),
                      precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(np.mean(interp)), float(recall[-1])


class COCOEvaluator:
    """Streaming COCO-protocol evaluator: feed per-image detections + GT
    with :meth:`add`, read metrics with :meth:`summarize`.

    Memory is O(total detections) — per-image matching happens inside
    ``add`` and images are never retained (fixes round-1's
    whole-dataset-in-RAM ``evaluate_model``).
    """

    def __init__(self, num_classes: int,
                 iou_thresholds: np.ndarray = IOU_THRESHOLDS,
                 max_dets: Sequence[int] = (1, 10, 100),
                 area_ranges: Optional[Dict[str, Tuple[float, float]]] = None):
        self.num_classes = num_classes
        self.iou_thresholds = np.asarray(iou_thresholds)
        self.max_dets = tuple(sorted(max_dets))
        self.area_ranges = dict(area_ranges or AREA_RANGES)
        if "all" not in self.area_ranges:
            raise ValueError("area_ranges must include 'all'")
        # pooled[(class, thr_idx, area, max_det)] = [scores...], [tp...], [ig...]
        self._pooled: Dict[tuple, tuple] = {}
        # num_gt[(class, area)] = count of non-ignored GT
        self._num_gt: Dict[tuple, int] = {}

    def _pool(self, key):
        if key not in self._pooled:
            self._pooled[key] = ([], [], [])
        return self._pooled[key]

    def add(self, det: Dict, gt: Dict):
        """One image.  ``det``: boxes [N,4] (t,l,b,r), scores [N],
        class_ids [N]; ``gt``: boxes [M,4], class_ids [M], optionally
        ``iscrowd`` [M] — crowd GTs are ignore *regions* (COCOeval:
        IoF matching, multi-matchable, never counted toward recall)."""
        det_boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        det_scores = np.asarray(det["scores"], np.float32)
        det_cls = np.asarray(det["class_ids"])
        gt_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        gt_cls = np.asarray(gt["class_ids"])
        gt_crowd = (np.asarray(gt["iscrowd"], bool)
                    if gt.get("iscrowd") is not None
                    else np.zeros(len(gt_boxes), bool))
        # COCOeval's area-range ignores read the annotation's ``area`` field
        # (segmentation area on real COCO), not the bbox area — honor it
        # when the caller provides one.
        gt_area = (np.asarray(gt["areas"], np.float32)
                   if gt.get("areas") is not None else _box_area(gt_boxes))

        classes = set(np.unique(det_cls)) | set(np.unique(gt_cls))
        for c in classes:
            c = int(c)
            d_sel = det_cls == c
            g_sel = gt_cls == c
            db, ds = det_boxes[d_sel], det_scores[d_sel]
            gb, ga, gc = gt_boxes[g_sel], gt_area[g_sel], gt_crowd[g_sel]
            # Pre-truncate to the largest maxDets once (score-sorted).
            order = np.argsort(-ds, kind="stable")
            db, ds = db[order], ds[order]
            top_md = self.max_dets[-1]
            for area_name, (lo, hi) in self.area_ranges.items():
                # COCOeval _prepare: _ignore = iscrowd OR out-of-area-range.
                gt_ig = gc | (ga < lo) | (ga > hi)
                key = (c, area_name)
                self._num_gt[key] = self._num_gt.get(key, 0) + int(
                    np.sum(~gt_ig))
                for t, thr in enumerate(self.iou_thresholds):
                    # Match once at the largest maxDets and prefix-slice for
                    # the smaller ones — equivalent because greedy matching
                    # in score order never lets a later det affect an
                    # earlier det's match (exactly COCOeval's accumulate
                    # slicing of dtMatches[:, :maxDet]; crowds preserve
                    # this — they stay matchable regardless of earlier
                    # matches).
                    scores, tp, dig = _match_image(
                        db[:top_md], ds[:top_md], gb, float(thr), gt_ig,
                        (lo, hi), gt_crowd=gc)
                    for md in self.max_dets:
                        pool = self._pool((c, t, area_name, md))
                        pool[0].append(scores[:md])
                        pool[1].append(tp[:md])
                        pool[2].append(dig[:md])

    def _ap_matrix(self, area_name: str, max_det: int):
        """(AP, AR) arrays [num_classes, num_thresholds] (nan = no GT)."""
        nt = len(self.iou_thresholds)
        ap = np.full((self.num_classes, nt), np.nan)
        ar = np.full((self.num_classes, nt), np.nan)
        for c in range(self.num_classes):
            num_gt = self._num_gt.get((c, area_name), 0)
            if num_gt == 0:
                continue
            for t in range(nt):
                pool = self._pooled.get((c, t, area_name, max_det))
                if pool is None:
                    ap[c, t], ar[c, t] = 0.0, 0.0
                    continue
                scores = np.concatenate(pool[0]) if pool[0] else np.zeros(0)
                tp = np.concatenate(pool[1]) if pool[1] else np.zeros(0, bool)
                dig = np.concatenate(pool[2]) if pool[2] else np.zeros(0, bool)
                ap[c, t], ar[c, t] = _average_precision(scores, tp, dig,
                                                        num_gt)
        return ap, ar

    def per_class_ap(self) -> np.ndarray:
        """[num_classes] mAP@[.5:.95] per class (nan = no GT) — the
        COCO-protocol per-category diagnostic (cocoeval's precision
        matrix averaged per catId)."""
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ap_all, _ = self._ap_matrix("all", self.max_dets[-1])
            return np.nanmean(ap_all, axis=1)

    def summarize(self) -> Dict[str, float]:
        thr = self.iou_thresholds
        idx50 = int(np.argmin(np.abs(thr - 0.5)))
        idx75 = int(np.argmin(np.abs(thr - 0.75)))
        top_md = self.max_dets[-1]

        import warnings
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # nanmean of an all-nan class/area slice (e.g. no medium GT) is
            # a legitimate nan result, not a warning-worthy event.
            warnings.simplefilter("ignore", RuntimeWarning)
            ap_all, ar_all = self._ap_matrix("all", top_md)
            per_thr = np.nanmean(ap_all, axis=0)
            out = {
                "mAP": float(np.nanmean(ap_all)),
                "AP50": float(per_thr[idx50]),
                "AP75": float(per_thr[idx75]),
            }
            for area in ("small", "medium", "large"):
                if area in self.area_ranges:
                    ap_a, _ = self._ap_matrix(area, top_md)
                    out[f"mAP_{area}"] = float(np.nanmean(ap_a))
            for md in self.max_dets:
                _, ar_md = self._ap_matrix("all", md)
                out[f"AR@{md}"] = float(np.nanmean(ar_md))
        return out


def evaluate_detections(
    detections: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> Dict[str, float]:
    """COCO-style AP over an in-memory dataset (thin wrapper over the
    streaming :class:`COCOEvaluator`).

    ``detections[i]`` / ``ground_truths[i]``: dicts for image i with
    ``boxes`` [N,4] (t,l,b,r — any consistent unit), ``class_ids`` [N]; the
    detection dicts also carry ``scores`` [N].
    """
    assert len(detections) == len(ground_truths)
    ev = COCOEvaluator(num_classes, iou_thresholds)
    for det, gt in zip(detections, ground_truths):
        ev.add(det, gt)
    return ev.summarize()


def evaluate_model(detector, loader, config, max_images: int = None,
                   score_threshold: float = None,
                   detections_sink=None,
                   protocol: str = "coco",
                   per_class: bool = False,
                   process_shard=None) -> Dict[str, float]:
    """Run the detector over a loader and compute mAP, streaming.

    ``detector`` is any object with ``detect(images, scales=)`` returning
    per-image dicts of numpy ``boxes`` (original-image pixels when
    ``scales`` is given), ``scores`` and ``class_ids`` — the port's
    ``infer.Detector``.

    ``protocol="voc"`` swaps in the Pascal VOC evaluator (single 0.5-IoU
    threshold, difficult-GT ignores, VOC07 11-point + VOC12 continuous
    AP — see :mod:`retinanet_tpu_torch.eval_voc`).

    One pass over the loader; each sample is preprocessed, batched (partial
    batches are padded to keep one batch shape per canvas), detected,
    matched into the evaluator, and dropped.  Detections are produced in
    canvas coordinates and mapped back to original-image pixels via the
    per-sample resize scale; GT comes straight from the loader sample
    (original pixels).  Memory is O(batch), not O(dataset).

    Honors ``config.data.buckets``: each sample lands on its least-padding
    rectangular canvas and batches are bucket-homogeneous, exactly like
    training — so a model trained with ``--buckets`` evaluates under the
    same padding geometry.  No sample is ever dropped (unlike the
    training pipeline's static-batch remainder drop).

    ``detections_sink(gt_meta, det)``, if given, receives each image's
    post-threshold detections (original-pixel [t,l,b,r] boxes) together
    with its GT dict (which carries ``image_id`` when the loader provides
    one) — the hook behind ``evaluate --dump-detections``, which exports
    canonical COCO-results JSON for offline pycocotools cross-validation.

    ``process_shard=(shard, num_shards)``: multi-process evaluation, one
    shard a rank (``evaluate`` passes ``(rank, world size)``).  Each rank
    detects the samples ``i % num_shards == shard``; the per-image records
    are all-gathered once at the end (``allgather_pyobjs``) and replayed
    in global dataset order, so every rank returns the metrics of one
    process over the whole set (ties on equal scores included, which
    follow the order of ``add``), and ``detections_sink`` sees every
    image, in that order, on every rank.
    """
    import dataclasses

    from retinanet_tpu_torch.data.pipeline import process_sample, select_canvas
    from retinanet_tpu_torch.parallel.distributed import (allgather_pyobjs,
                                                          shard_loader,
                                                          world_size)

    data_cfg = dataclasses.replace(config.data, augment_flip=False,
                                   augment_photometric=False)
    mean = np.asarray(data_cfg.mean, np.float32)
    std = np.asarray(data_cfg.std, np.float32)
    batch_size = data_cfg.batch_size

    if protocol == "voc":
        from retinanet_tpu_torch.eval_voc import VOCEvaluator
        evaluator = VOCEvaluator(loader.num_classes)
    elif protocol == "coco":
        evaluator = COCOEvaluator(loader.num_classes)
    else:
        raise ValueError(f"unknown eval protocol: {protocol!r}")
    shard, num_shards = process_shard or (0, 1)
    if num_shards > 1 and num_shards != world_size():
        raise ValueError(f"process_shard={process_shard} needs {num_shards} "
                         f"ranks, the group has {world_size()}")
    # Sharded runs defer add and sink: (global index, gt, det) records
    # collect here and replay in global order after the all-gather.
    records: list = []

    # canvas (h, w) -> ([images], [scales], [global indices], [gts])
    pending: Dict[tuple, tuple] = {}

    def flush(canvas):
        images, scales, idxs, gts = pending.pop(canvas, ([], [], [], []))
        if not images:
            return
        n = len(images)
        while len(images) < batch_size:  # pad: keep shapes static
            images.append(np.zeros_like(images[0]))
            scales.append(1.0)
        results = detector.detect(np.stack(images),
                                  scales=np.asarray(scales, np.float32))
        for det, idx, gt in zip(results[:n], idxs, gts):
            if score_threshold is not None:
                keep = det["scores"] >= score_threshold
                det = {k: v[keep] for k, v in det.items()}
            if num_shards > 1:
                records.append((idx, gt, det))
                continue
            if detections_sink is not None:
                detections_sink(gt, det)
            evaluator.add(det, gt)

    for k, sample in enumerate(shard_loader(loader, shard, num_shards)):
        # The global dataset index (a shard's k-th sample is the loader's
        # shard + k·num_shards); max_images caps globally, so sharded and
        # one-process runs see the same images.
        i = shard + k * num_shards
        if max_images is not None and i >= max_images:
            break
        sample, canvas = select_canvas(sample, data_cfg)
        out = process_sample(sample, canvas, mean, std,
                             max_boxes=config.assign.max_boxes, flip=False)
        images, scales, idxs, gts = pending.setdefault(
            canvas, ([], [], [], []))
        images.append(out["image"])
        scales.append(float(out["scale"]))
        idxs.append(i)
        gts.append({"boxes": np.asarray(sample["boxes"], np.float32),
                    "class_ids": np.asarray(sample["class_ids"]),
                    "iscrowd": sample.get("iscrowd"),
                    "areas": sample.get("areas"),
                    "difficult": sample.get("difficult"),
                    # Running index fallback keeps the dump usable for
                    # loaders without native ids (shapes, pascal).
                    "image_id": sample.get("image_id", i)})
        if len(images) == batch_size:
            flush(canvas)
    for canvas in list(pending):
        flush(canvas)
    if num_shards > 1:
        merged = sorted((r for rank in allgather_pyobjs(records)
                         for r in rank), key=lambda r: r[0])
        for _, gt, det in merged:
            if detections_sink is not None:
                detections_sink(gt, det)
            evaluator.add(det, gt)
    metrics = evaluator.summarize()
    if per_class:
        # Per-category diagnostic (COCO: mAP@[.5:.95]; VOC: VOC07 AP);
        # nan → None so the record stays strict-JSON.
        ap = evaluator.per_class_ap()
        metrics["AP_per_class"] = {
            name: (None if np.isnan(ap[c]) else round(float(ap[c]), 4))
            for c, name in enumerate(loader.class_names)}
    return metrics
