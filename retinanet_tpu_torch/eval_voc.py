"""Pascal VOC detection evaluation (the official ``voc_eval.py`` protocol;
a copy of ``retinanet_tpu/eval_voc.py``).

Companion to :mod:`retinanet_tpu_torch.eval_coco` for VOC-style datasets:

  * single IoU threshold (0.5 by default), no maxDets cap, no area ranges;
  * ``difficult`` GT objects are ignored — a detection matching one is
    neither TP nor FP, and difficult GTs don't count toward recall;
  * matching differs from COCO: each detection (score order) takes the
    **argmax-IoU** GT of its class; if that GT was already matched the
    detection is a false positive (COCO's greedy instead scans for the
    best *unmatched* GT);
  * AP: VOC2007 11-point interpolation AND the VOC2010+ continuous
    (area-under-monotone-envelope) metric, both reported.

The reference has no evaluation at all (its ``pascal.py`` loader is
training-only and drops the ``difficult`` flag); this module completes the
VOC story the same way eval_coco completed COCO's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _voc_iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the official devkit's +1 pixel-inclusive
    convention (``voc_eval.py``: every extent is ``max - min + 1`` — VOC
    boxes are inclusive pixel ranges).  This deliberately differs from
    the continuous IoU used everywhere else in the framework; near the
    0.5 threshold the two flip matches on real integer-pixel VOC data."""
    it = np.maximum(det[:, None, 0], gt[None, :, 0])
    il = np.maximum(det[:, None, 1], gt[None, :, 1])
    ib = np.minimum(det[:, None, 2], gt[None, :, 2])
    ir = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = (np.maximum(ib - it + 1.0, 0.0)
             * np.maximum(ir - il + 1.0, 0.0))
    area_d = ((det[:, 2] - det[:, 0] + 1.0)
              * (det[:, 3] - det[:, 1] + 1.0))
    area_g = ((gt[:, 2] - gt[:, 0] + 1.0)
              * (gt[:, 3] - gt[:, 1] + 1.0))
    union = area_d[:, None] + area_g[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def _match_image_voc(det_boxes: np.ndarray, det_scores: np.ndarray,
                     gt_boxes: np.ndarray, gt_difficult: np.ndarray,
                     iou_threshold: float):
    """voc_eval's per-image matching for one class.

    Returns (scores, tp, det_ignore) in descending-score order.  Unlike
    COCO's matcher, a detection whose argmax GT is already used is a FP
    even if another unmatched GT also clears the threshold.
    """
    order = np.argsort(-det_scores, kind="stable")
    det_boxes, det_scores = det_boxes[order], det_scores[order]
    tp = np.zeros(len(det_boxes), bool)
    det_ig = np.zeros(len(det_boxes), bool)
    if len(gt_boxes) == 0:
        return det_scores, tp, det_ig  # all FP
    iou = _voc_iou_matrix(np.asarray(det_boxes, np.float64),
                          np.asarray(gt_boxes, np.float64))
    used = np.zeros(len(gt_boxes), bool)
    for d in range(len(det_boxes)):
        g = int(np.argmax(iou[d])) if iou.shape[1] else -1
        # Official voc_eval accepts strictly ABOVE the threshold
        # (``if ovmax > ovthresh``) — unlike pycocotools' >=.
        if g < 0 or iou[d, g] <= iou_threshold:
            continue  # FP
        if gt_difficult[g]:
            det_ig[d] = True  # neither TP nor FP (voc_eval: continue)
        elif not used[g]:
            used[g] = True
            tp[d] = True
        # else: already matched -> FP (tp stays False)
    return det_scores, tp, det_ig


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool) -> float:
    """AP from a (recall, precision) curve — voc_eval's two formulas."""
    if use_07_metric:
        ap = 0.0
        for r in np.arange(0.0, 1.01, 0.1):
            p = precision[recall >= r]
            ap += (float(p.max()) if len(p) else 0.0) / 11.0
        return ap
    # VOC2010+: exact area under the monotone precision envelope.
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class VOCEvaluator:
    """Streaming VOC evaluator mirroring :class:`COCOEvaluator`'s
    interface: feed per-image (det, gt) with :meth:`add`, read metrics
    with :meth:`summarize`.  Memory is O(total detections)."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou_threshold = float(iou_threshold)
        self._pooled: Dict[int, tuple] = {}
        self._num_gt = np.zeros(num_classes, np.int64)

    def add(self, det: Dict, gt: Dict):
        """``det``: boxes [N,4] (t,l,b,r), scores [N], class_ids [N];
        ``gt``: boxes [M,4], class_ids [M], optionally ``difficult`` [M]."""
        det_boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        det_scores = np.asarray(det["scores"], np.float32)
        det_cls = np.asarray(det["class_ids"])
        gt_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        gt_cls = np.asarray(gt["class_ids"])
        difficult = (np.asarray(gt["difficult"], bool)
                     if gt.get("difficult") is not None
                     else np.zeros(len(gt_boxes), bool))

        for c in set(np.unique(det_cls)) | set(np.unique(gt_cls)):
            c = int(c)
            d_sel, g_sel = det_cls == c, gt_cls == c
            self._num_gt[c] += int(np.sum(~difficult[g_sel]))
            scores, tp, dig = _match_image_voc(
                det_boxes[d_sel], det_scores[d_sel], gt_boxes[g_sel],
                difficult[g_sel], self.iou_threshold)
            pool = self._pooled.setdefault(c, ([], [], []))
            pool[0].append(scores)
            pool[1].append(tp)
            pool[2].append(dig)

    def _class_ap(self, c: int):
        num_gt = int(self._num_gt[c])
        if num_gt == 0:
            return np.nan, np.nan
        pool = self._pooled.get(c)
        if pool is None or not pool[0]:
            return 0.0, 0.0
        scores = np.concatenate(pool[0])
        tp = np.concatenate(pool[1])
        dig = np.concatenate(pool[2])
        keep = ~dig
        scores, tp = scores[keep], tp[keep]
        if len(scores) == 0:
            return 0.0, 0.0
        order = np.argsort(-scores, kind="stable")
        tp = tp[order]
        cum_tp = np.cumsum(tp)
        recall = cum_tp / num_gt
        precision = cum_tp / np.maximum(
            cum_tp + np.cumsum(~tp), 1e-12)
        return (voc_ap(recall, precision, use_07_metric=True),
                voc_ap(recall, precision, use_07_metric=False))

    def per_class_ap(self) -> np.ndarray:
        """[num_classes] VOC07 AP per class (nan = no GT)."""
        return np.array([self._class_ap(c)[0]
                         for c in range(self.num_classes)])

    def summarize(self) -> Dict[str, float]:
        ap07 = np.full(self.num_classes, np.nan)
        ap12 = np.full(self.num_classes, np.nan)
        for c in range(self.num_classes):
            ap07[c], ap12[c] = self._class_ap(c)
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return {"mAP_voc07": float(np.nanmean(ap07)),
                    "mAP_voc12": float(np.nanmean(ap12))}


def evaluate_detections_voc(detections: Sequence[Dict],
                            ground_truths: Sequence[Dict],
                            num_classes: int,
                            iou_threshold: float = 0.5,
                            ) -> Dict[str, float]:
    """In-memory wrapper over the streaming :class:`VOCEvaluator`."""
    assert len(detections) == len(ground_truths)
    ev = VOCEvaluator(num_classes, iou_threshold)
    for det, gt in zip(detections, ground_truths):
        ev.add(det, gt)
    return ev.summarize()
