"""On-device anchor↔ground-truth label assignment (port of
``retinanet_tpu/ops/assign.py``).

Static ``[..., MAX_BOXES, 4]`` padded boxes with a validity mask in, per-level
labels out, on the boxes' device.  Any leading batch dimensions are carried
through (the JAX package vmaps ``build_labels``; here ``build_labels_batch``
is the same function over a leading batch dimension).  Semantics:

* anchors = cell-centre grid × normalized anchor sizes;
* match = max IoU over the valid boxes, argmax picking the lowest index on
  ties (``torch.argmax`` returns the first maximal index, as ``jnp.argmax``);
* background = ``iou < pos_iou_threshold`` under ``bg_uses_pos_threshold``
  (the reference's quirk), else ``iou < neg_iou_threshold``;
* trainable = ``iou < neg or iou >= pos``;
* classification = one-hot of the matched class, zero where background;
* regression = (shift, log-scale) of the matched box against each anchor.

The JAX package selects the matched class and box with a one-hot × table
matmul at ``Precision.HIGHEST``, a TPU tactic that reproduces table rows
exactly; a gather returns the same rows bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import Tensor

from retinanet_tpu_torch.config import AssignConfig
from retinanet_tpu_torch.ops import boxes as box_ops
from retinanet_tpu_torch.ops.anchors import Levels


def _match(anchor_corner: Tensor, boxes: Tensor, box_mask: Tensor,
           chunk: int) -> Tuple[Tensor, Tensor]:
    """(max IoU, first-wins argmax index) of every anchor over the padded
    boxes.  ``anchor_corner`` [H, W, A, 4]; ``boxes`` [*lead, M, 4];
    ``box_mask`` [*lead, M]; returns [*lead, H, W, A] each.

    ``chunk == 0`` materializes the [*lead, H, W, A, M] IoU at once;
    ``chunk > 0`` walks the boxes in chunks of that size with a running
    (best IoU, best index), replacing only on a strictly greater IoU, so
    the earlier chunk wins ties: the same result as the dense path.
    """
    lead = boxes.shape[:-2]
    anchors = anchor_corner[..., None, :]                  # [H, W, A, 1, 4]

    def chunk_match(b: Tensor, m: Tensor):
        k = b.shape[-2]
        iou = box_ops.iou(anchors, b.reshape(*lead, 1, 1, 1, k, 4))
        iou = torch.where(m.reshape(*lead, 1, 1, 1, k), iou,
                          torch.full_like(iou, -1.0))
        return iou.max(dim=-1)

    if chunk <= 0:
        best_iou, best_idx = chunk_match(boxes, box_mask)
        return best_iou, best_idx

    n = boxes.shape[-2]
    best_iou = best_idx = None
    for start in range(0, n, chunk):
        b = boxes[..., start:start + chunk, :]
        m = box_mask[..., start:start + chunk]
        if b.shape[-2] < chunk:  # pad the tail as the JAX scan does
            pad = chunk - b.shape[-2]
            b = torch.cat([b, b.new_zeros(*lead, pad, 4)], dim=-2)
            m = torch.cat([m, m.new_zeros(*lead, pad)], dim=-1)
        c_iou, c_idx = chunk_match(b, m)
        c_idx = c_idx + start
        if best_iou is None:
            best_iou, best_idx = c_iou, c_idx
            continue
        better = c_iou > best_iou
        best_iou = torch.where(better, c_iou, best_iou)
        best_idx = torch.where(better, c_idx, best_idx)
    return best_iou, best_idx


def level_labels(boxes: Tensor, class_ids: Tensor, box_mask: Tensor,
                 anchor_sizes: Tensor, grid_h: int, grid_w: int,
                 num_classes: int, cfg: AssignConfig = AssignConfig()
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Labels of one pyramid level.

    ``boxes`` [*lead, M, 4] corner (t,l,b,r), image-relative, float32;
    ``class_ids`` [*lead, M] int; ``box_mask`` [*lead, M] bool;
    ``anchor_sizes`` [A, 2] image-relative (h, w).  Returns
    ``(classification [*lead,H,W,A,C] f32, regression [*lead,H,W,A,4] f32,
    trainable_mask [*lead,H,W,A] bool)``.
    """
    num_anchors = anchor_sizes.shape[0]
    shape = (grid_h, grid_w, num_anchors, 2)
    grid = box_ops.position_grid(grid_h, grid_w, device=boxes.device)
    anchor_pos = grid[:, :, None, :].expand(shape)
    anchor_size = anchor_sizes.to(boxes.device, torch.float32)[
        None, None].expand(shape)
    anchor_corner = box_ops.from_center_box(
        torch.cat([anchor_pos, anchor_size], dim=-1))

    match_iou, match_idx = _match(anchor_corner, boxes, box_mask,
                                  cfg.match_chunk)

    bg_threshold = (cfg.pos_iou_threshold if cfg.bg_uses_pos_threshold
                    else cfg.neg_iou_threshold)
    bg_mask = match_iou < bg_threshold
    trainable_mask = (match_iou < cfg.neg_iou_threshold) | (
        match_iou >= cfg.pos_iou_threshold)

    # Table rows [*lead, M, C+4]: the class one-hot (out-of-range ids give
    # a zero row, as jax.nn.one_hot) beside the center box; one gather.
    onehot = (class_ids[..., None] == torch.arange(
        num_classes, device=boxes.device)).to(torch.float32)
    table = torch.cat([onehot, box_ops.to_center_box(boxes)], dim=-1)
    lead, n = boxes.shape[:-2], grid_h * grid_w * num_anchors
    flat_idx = match_idx.reshape(*lead, n, 1).expand(*lead, n,
                                                     table.shape[-1])
    selected = torch.gather(table, -2, flat_idx).reshape(
        *match_idx.shape, table.shape[-1])

    classification = selected[..., :num_classes]
    classification = torch.where(bg_mask[..., None],
                                 torch.zeros_like(classification),
                                 classification)
    matched_pos, matched_size = selected[..., num_classes:].split(2, dim=-1)
    # Padded boxes have zero size: clamp before the log.  Such anchors are
    # always background or ignored, and the loss masks them out.
    safe_size = torch.clamp(matched_size, min=1e-8)
    shifts = (matched_pos - anchor_pos) / anchor_size
    regression = torch.cat([shifts, torch.log(safe_size / anchor_size)],
                           dim=-1)
    return classification, regression, trainable_mask


def build_labels(boxes: Tensor, class_ids: Tensor, box_mask: Tensor,
                 image_size, levels: Levels, num_classes: int,
                 cfg: AssignConfig = AssignConfig()
                 ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor],
                            Dict[str, Tensor]]:
    """Per-level ``(classifications, regressions, trainable_masks)`` keyed
    by P3..P7; ``image_size`` is an int (square) or an (h, w) canvas."""
    classifications, regressions, masks = {}, {}, {}
    for pn in levels:
        gh, gw = levels.grid_hw(pn, image_size)
        sizes = torch.from_numpy(levels.normalized_anchor_sizes(pn,
                                                                image_size))
        classifications[pn], regressions[pn], masks[pn] = level_labels(
            boxes, class_ids, box_mask, sizes, gh, gw, num_classes, cfg)
    return classifications, regressions, masks


def build_labels_batch(boxes: Tensor, class_ids: Tensor, box_mask: Tensor,
                       image_size, levels: Levels, num_classes: int,
                       cfg: AssignConfig = AssignConfig()):
    """:func:`build_labels` over a leading batch dimension: ``boxes``
    [B, M, 4], ``class_ids`` and ``box_mask`` [B, M]."""
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be [B, M, 4], got {tuple(boxes.shape)}")
    return build_labels(boxes, class_ids, box_mask, image_size, levels,
                        num_classes, cfg)
