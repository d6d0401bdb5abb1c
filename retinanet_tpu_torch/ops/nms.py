"""Static-shape decode + classwise greedy NMS (port of
``retinanet_tpu/ops/nms.py``: ``BoxesDecoded``, ``classmap_decode``,
``_select_level_candidates``, the reference path ``decode_level`` /
``decode_levels`` / ``nms_padded``, ``_greedy_keep_mask`` and the serving
path ``fused_decode_nms``).

Suppression goes through ``nms_keep_mask_batch``: the hand-written CUDA
kernel (``csrc/nms.cu``, port of ``ops/pallas/nms_kernel.py``) for a CUDA
tensor, ``_greedy_keep_mask`` for a CPU tensor.  The JAX package's three
suppression choices (``use_pallas``, "sequential", "jacobi") compute the
same bit-exact greedy mask, so they are one function here.

``jax.lax.top_k`` puts the lowest index first among equal values; every
selection here is a stable descending sort, which does the same.  Torch
has no approximate top-k: ``approx`` and ``use_approx_top_k`` take the
exact one (JAX's CPU lowering of ``approx_max_k`` returns the exact set
too).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from retinanet_tpu_torch.config import AnchorConfig, NMSConfig
from retinanet_tpu_torch.ops.anchors import Levels, flat_anchor_maps, image_hw
from retinanet_tpu_torch.ops import boxes as box_ops
from retinanet_tpu_torch.ops.cuda import KernelLibrary, check_cuda, stream_ptr

_P = ctypes.c_void_p
LIB = KernelLibrary("nms.cu", {
    "nms_keep_mask_fwd": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          _P, _P, _P],
})


# B2's largest N: the scan keeps a 64-bit removed word per 64 boxes in
# shared memory beside a ring of at least two slots (``csrc/nms.cu``).
MAX_BOXES = 1 << 20


class BoxesDecoded(NamedTuple):
    """Padded detections: corner boxes, scores, class ids and validity."""

    boxes: Tensor      # [..., K, 4]
    scores: Tensor     # [..., K]
    class_ids: Tensor  # [..., K] int32
    valid: Tensor      # [..., K] bool


def classmap_decode(classmap: Tensor, threshold: float = 0.5) -> Tensor:
    """fg_mask = max class prob > threshold."""
    return classmap.amax(dim=-1) > threshold


def _top_k(x: Tensor, k: int):
    """Descending top-k along the last dim, lowest index first on ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _select_level_candidates(classifications: Tensor, top_k: int):
    """(scores [B,k], class_ids [B,k], flat_idx [B,k]) of one level.

    bf16 logits with ≤128 classes take the packed-key path: the best logit
    and its class come from one max over ``(monotone16(logit) << 7) |
    (127 − class)``, which orders ties by lower class, then by lower
    anchor index, exactly as the JAX package does.
    """
    b, h, w, a, num_classes = classifications.shape
    n = h * w * a
    k = min(top_k, n)
    if classifications.dtype == torch.bfloat16 and num_classes <= 128:
        u = classifications.view(torch.int16).to(torch.int32) & 0xFFFF
        key = torch.where(u >> 15 == 1, u ^ 0xFFFF, u | 0x8000)
        cls_rank = 127 - torch.arange(num_classes, dtype=torch.int32,
                                      device=u.device)
        best = ((key << 7) + cls_rank).amax(dim=-1).reshape(b, n)
        pk, top_idx = _top_k(best, k)
        ids = 127 - (pk & 127)
        key_t = pk >> 7
        u16 = torch.where((key_t & 0x8000) != 0, key_t ^ 0x8000,
                          key_t ^ 0xFFFF)
        signed = torch.where(u16 >= 0x8000, u16 - 0x10000, u16)
        top_logits = signed.to(torch.int16).view(torch.bfloat16).float()
    else:
        best_logit = classifications.amax(dim=-1).float().reshape(b, n)
        top_logits, top_idx = _top_k(best_logit, k)
        rows = torch.gather(
            classifications.reshape(b, n, num_classes), 1,
            top_idx[..., None].expand(b, k, num_classes))
        ids = rows.argmax(dim=-1).to(torch.int32)
    return torch.sigmoid(top_logits), ids.to(torch.int32), top_idx


def _greedy_keep_mask(boxes: Tensor, iou_threshold: float) -> Tensor:
    """Plain greedy keep mask of score-sorted boxes [B,N,4] → [B,N] bool:
    i is kept iff no kept j < i has IoU(j, i) > thr."""
    n = boxes.shape[-2]
    iou = box_ops.pairwise_iou(boxes, boxes)
    idx = torch.arange(n, device=boxes.device)
    active = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                        device=boxes.device)
    for i in range(n):
        suppress = ((iou[:, i] > iou_threshold) & (idx > i)
                    & active[:, i:i + 1])
        active &= ~suppress
    return active


def nms_keep_mask_batch(boxes: Tensor, iou_threshold: float = 0.5) -> Tensor:
    """Keep mask [B,N] bool of score-sorted corner boxes [B,N,4] float32.

    CUDA: kernel B2, the upper-triangle bitmask (N²/16 bytes of scratch
    per image) and a block-wise scan; two launches, N ≤ ``MAX_BOXES``.
    CPU: ``_greedy_keep_mask``.
    """
    if not boxes.is_cuda:
        return _greedy_keep_mask(boxes, iou_threshold)
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B,N,4], got {tuple(boxes.shape)}")
    check_cuda(boxes, "boxes", torch.float32)
    bsz, n, _ = boxes.shape
    if n > MAX_BOXES:
        raise ValueError(f"the CUDA NMS kernel takes N <= {MAX_BOXES} "
                         f"(MAX_BOXES), got {n}")
    keep = torch.empty(bsz, n, dtype=torch.bool, device=boxes.device)
    if n == 0 or bsz == 0:
        return keep
    nw = -(-n // 64)  # 64-box blocks; the mask holds their upper triangle
    mask = torch.empty(bsz, nw * (nw + 1) // 2, 64, dtype=torch.int64,
                       device=boxes.device)
    LIB.call("nms_keep_mask_fwd", boxes.data_ptr(), bsz, n,
             float(iou_threshold), mask.data_ptr(), keep.data_ptr(),
             stream_ptr(boxes.device))
    nms_keep_mask_batch.launches += 1
    return keep


nms_keep_mask_batch.launches = 0


def nms_keep_mask(boxes: Tensor, iou_threshold: float = 0.5) -> Tensor:
    """Keep mask [N] of score-sorted corner boxes [N,4] (batch of one)."""
    return nms_keep_mask_batch(boxes[None], iou_threshold)[0]


def _suppression_boxes(boxes: Tensor, ids: Tensor, valid: Tensor,
                       classwise: bool = True) -> Tensor:
    """The boxes suppression sees: offset by ``class_id·4`` (classwise) so
    that boxes of different classes never overlap, invalid ones parked
    1e4 away so they overlap no valid box.  Contiguous [B,N,4]."""
    if classwise:
        boxes = boxes + (ids[..., None] * 4.0).to(boxes.dtype)
    return torch.where(valid[..., None], boxes, boxes - 1e4).contiguous()


def _select_detections(cand: BoxesDecoded, keep: Tensor,
                       max_output_size: int) -> BoxesDecoded:
    """The top ``max_output_size`` kept candidates by score; slots past
    the survivors hold score 0 and ``valid`` False."""
    out_scores = torch.where(keep, cand.scores,
                             torch.full_like(cand.scores, -1.0))
    b = out_scores.shape[0]
    k = min(max_output_size, out_scores.shape[1])
    sel_scores, sel_idx = _top_k(out_scores, k)
    return BoxesDecoded(
        boxes=torch.gather(cand.boxes, 1,
                           sel_idx[..., None].expand(b, k, 4)),
        scores=torch.where(sel_scores > 0, sel_scores,
                           torch.zeros_like(sel_scores)),
        class_ids=torch.gather(cand.class_ids, 1, sel_idx),
        valid=sel_scores > 0,
    )


def decode_level(classifications: Tensor, regressions: Tensor,
                 anchor_sizes: Tensor, top_k: int, score_threshold: float,
                 approx: bool = False, approx_recall: float = 0.95
                 ) -> BoxesDecoded:
    """Top-k candidates of one level: logits [B,H,W,A,C], regressions
    [B,H,W,A,4], normalized anchor sizes [A,2] → BoxesDecoded [B,k].

    The top-k runs on the max-logit map (``_select_level_candidates``,
    packed keys for bf16 with ≤128 classes) and only the k winners are
    sigmoided and decoded; the anchor's centre and size come from the flat
    index (y·W + x)·A + a arithmetically, as the JAX function computes
    them.  ``approx`` and ``approx_recall`` name a TPU unit; the top-k is
    exact.
    """
    b, h, w, a = classifications.shape[:4]
    scores, ids, top_idx = _select_level_candidates(classifications, top_k)
    k = top_idx.shape[1]
    regr = torch.gather(regressions.reshape(b, h * w * a, 4), 1,
                        top_idx[..., None].expand(b, k, 4)).float()
    ai = top_idx % a
    cell = top_idx // a
    cy = ((cell // w).float() + 0.5) / h
    cx = ((cell % w).float() + 0.5) / w
    asz = anchor_sizes.to(device=top_idx.device, dtype=torch.float32)[ai]
    shift, log_scale = regr.split(2, dim=-1)
    center = shift * asz + torch.stack([cy, cx], dim=-1)
    size = torch.exp(log_scale) * asz
    boxes = box_ops.from_center_box(torch.cat([center, size], dim=-1))
    return BoxesDecoded(boxes=boxes, scores=scores, class_ids=ids,
                        valid=scores > score_threshold)


def decode_levels(classifications: Dict[str, Tensor],
                  regressions: Dict[str, Tensor], levels: Levels,
                  image_size, cfg: NMSConfig = NMSConfig()) -> BoxesDecoded:
    """``decode_level`` on every level, in sorted level-name order,
    concatenated: ``top_k_per_level`` (or fewer, where a level has fewer
    anchors) candidates per level."""
    parts = []
    for pn in sorted(classifications.keys()):
        anchor_sizes = torch.from_numpy(
            levels.normalized_anchor_sizes(pn, image_size))
        parts.append(decode_level(
            classifications[pn], regressions[pn], anchor_sizes,
            cfg.top_k_per_level, cfg.score_threshold,
            approx=cfg.use_approx_top_k,
            approx_recall=cfg.approx_top_k_recall))
    return BoxesDecoded(*(torch.cat(field, dim=1) for field in zip(*parts)))


def padded_candidates(decoded: BoxesDecoded, pre_nms_top_k: Optional[int],
                      classwise: bool = True
                      ) -> Tuple[BoxesDecoded, Tensor]:
    """The first half of ``nms_padded``: the top ``pre_nms_top_k`` (all
    where None) candidates by score, invalid ones scored −1, and the
    boxes suppression sees (``_suppression_boxes``)."""
    n = decoded.scores.shape[-1]
    k_in = min(pre_nms_top_k or n, n)
    masked = torch.where(decoded.valid, decoded.scores,
                         torch.full_like(decoded.scores, -1.0))
    top_scores, order = _top_k(masked, k_in)
    b = order.shape[0]
    boxes_s = torch.gather(decoded.boxes, 1,
                           order[..., None].expand(b, k_in, 4))
    ids_s = torch.gather(decoded.class_ids, 1, order)
    valid_s = top_scores > 0
    return (BoxesDecoded(boxes_s, top_scores, ids_s, valid_s),
            _suppression_boxes(boxes_s, ids_s, valid_s, classwise))


def nms_padded(decoded: BoxesDecoded, iou_threshold: float = 0.5,
               max_output_size: int = 1000, classwise: bool = True,
               use_pallas: Optional[bool] = None,
               pre_nms_top_k: Optional[int] = None,
               suppression: str = "sequential") -> BoxesDecoded:
    """Batched, static-shape (class-wise) greedy NMS over padded
    candidates [B,N]: per class, IoU ``iou_threshold``, at most
    ``max_output_size`` survivors by descending score.  Invalid candidates
    take part with score −1, parked far away, so they neither win nor
    suppress; ``pre_nms_top_k`` caps the candidates entering suppression
    (None: all N).  ``use_pallas`` and ``suppression`` choose among JAX's
    three ways to the same exact greedy mask; here every choice is
    ``nms_keep_mask_batch`` (B2 on the card)."""
    cand, shifted = padded_candidates(decoded, pre_nms_top_k, classwise)
    keep = nms_keep_mask_batch(shifted, iou_threshold) & cand.valid
    return _select_detections(cand, keep, max_output_size)


@functools.lru_cache(maxsize=16)
def _anchor_table(anchors: AnchorConfig, hw: Tuple[int, int],
                  device: torch.device) -> Tensor:
    """[N_total, 4] (cy, cx, h, w) of every anchor, built once per canvas
    and device; callers only read it."""
    table = flat_anchor_maps(Levels(anchors), hw)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def nms_candidates(classifications: Dict[str, Tensor],
                   regressions: Dict[str, Tensor], levels: Levels,
                   image_size, cfg: NMSConfig = NMSConfig()
                   ) -> Tuple[BoxesDecoded, Tensor]:
    """The pre-NMS half of ``fused_decode_nms``: per-level candidates, the
    global pre-NMS top-k, one regression gather and the anchor-table
    decode.  Returns the score-sorted candidates ``[B, k]`` and the
    class-offset boxes that suppression sees (invalid ones parked 1e4
    away so they overlap no valid box).

    ``cfg.use_approx_top_k`` names a TPU unit; selection here is exact.
    """
    names = sorted(classifications.keys())
    parts = [_select_level_candidates(classifications[pn],
                                      cfg.top_k_per_level)
             for pn in names]
    scores = torch.cat([p[0] for p in parts], dim=1)            # [B, K]
    ids = torch.cat([p[1] for p in parts], dim=1)

    offsets, off = [], 0
    for pn in names:
        gh, gw = levels.grid_hw(pn, image_size)
        offsets.append(off)
        off += gh * gw * levels.num_anchors
    gidx = torch.cat([p[2] + o for p, o in zip(parts, offsets)], dim=1)

    b = scores.shape[0]
    valid = scores > cfg.score_threshold
    masked = torch.where(valid, scores, torch.full_like(scores, -1.0))
    k_in = min(cfg.pre_nms_top_k, masked.shape[1])
    top_scores, order = _top_k(masked, k_in)                    # [B, k]
    ids_s = torch.gather(ids, 1, order)
    gidx_s = torch.gather(gidx, 1, order)
    valid_s = top_scores > 0

    regr_all = torch.cat([regressions[pn].reshape(b, -1, 4) for pn in names],
                         dim=1)
    regr = torch.gather(regr_all, 1,
                        gidx_s[..., None].expand(b, k_in, 4)).float()
    table = _anchor_table(levels.config, image_hw(image_size), scores.device)
    anchors = table[gidx_s]                                     # [B, k, 4]
    a_pos, a_size = anchors.split(2, dim=-1)
    shift, log_scale = regr.split(2, dim=-1)
    center = shift * a_size + a_pos
    size = torch.exp(log_scale) * a_size
    boxes_s = box_ops.from_center_box(torch.cat([center, size], dim=-1))

    return (BoxesDecoded(boxes_s, top_scores, ids_s, valid_s),
            _suppression_boxes(boxes_s, ids_s, valid_s))


def fused_decode_nms(classifications: Dict[str, Tensor],
                     regressions: Dict[str, Tensor], levels: Levels,
                     image_size, cfg: NMSConfig = NMSConfig()
                     ) -> BoxesDecoded:
    """Decode + classwise NMS with the box work deferred past the pre-NMS
    selection (``ops/nms.py:fused_decode_nms``): ``nms_candidates``, then
    class-offset greedy suppression and the top-k output."""
    cand, shifted = nms_candidates(classifications, regressions, levels,
                                   image_size, cfg)
    keep = nms_keep_mask_batch(shifted, cfg.iou_threshold) & cand.valid
    return _select_detections(cand, keep, cfg.max_output_size)
