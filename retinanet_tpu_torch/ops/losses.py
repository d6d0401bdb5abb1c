"""Detection losses (port of ``retinanet_tpu/ops/losses.py``).

Static shapes: full per-anchor maps plus a trainable-weight mask, so masked
anchors add exactly zero to every sum.  The dice, jaccard, fixed-IoU and
balanced-BCE terms reduce over the global flattened anchor axis of the whole
batch, and every reduction goes through :func:`_global_sum`: a local sum,
and with a ``group`` (the JAX package's ``axis_name``) its all-reduce over
the group's ranks (``parallel.distributed.global_sum``), so each rank's
loss is that of the global batch at any world size.

Class losses: ``bce`` (sigmoid BCE), ``focal`` (α=0.25, γ=2, normalized by
the foreground count), ``dice``, ``jaccard``, ``fixed_iou``,
``balanced_bce``; regression is Huber on foreground anchors with
SUM_BY_NONZERO_WEIGHTS semantics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from retinanet_tpu_torch.config import LossConfig
from retinanet_tpu_torch.parallel.distributed import global_sum

_EPS = 1e-7


def _global_sum(x: Tensor, group, dims: Optional[Sequence[int]] = None
                ) -> Tensor:
    """Sum over ``dims`` (all of them when None), then over the ranks of
    ``group`` (none when None): the sum over the global batch."""
    local = x.sum() if dims is None else x.sum(dim=tuple(dims))
    return global_sum(local, group)


def _leading_sum(x: Tensor, group) -> Tensor:
    """Per-class global sum: every axis but the last."""
    return _global_sum(x, group, range(x.dim() - 1))


def sigmoid_bce_with_logits(labels: Tensor, logits: Tensor) -> Tensor:
    """Numerically stable sigmoid cross-entropy."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def focal_sigmoid_bce_with_logits(labels: Tensor, logits: Tensor,
                                  focus: float = 2.0, alpha: float = 0.25,
                                  eps: float = _EPS) -> Tensor:
    prob = torch.sigmoid(logits)
    is_pos = labels == 1
    prob_true = torch.where(is_pos, prob, 1 - prob)
    alpha_t = torch.where(is_pos, torch.full_like(prob, alpha),
                          torch.full_like(prob, 1 - alpha))
    return -alpha_t * (1 - prob_true) ** focus * torch.log(prob_true + eps)


def _masked_class_sums(labels: Tensor, probs: Tensor, weights: Tensor,
                       group):
    """Per-class global sums of (labels·probs, labels, probs) over weighted
    anchors; ``weights`` [...] against ``labels``/``probs`` [..., C]."""
    w = weights[..., None]
    return (_leading_sum(labels * probs * w, group),
            _leading_sum(labels * w, group), _leading_sum(probs * w, group))


def dice_loss_masked(labels: Tensor, logits: Tensor, weights: Tensor,
                     smooth: float = 0.0, group=None) -> Tensor:
    """Per-class dice over all weighted anchors, mean over classes; the
    denominator is guarded with a tiny eps."""
    inter, lab_sum, prob_sum = _masked_class_sums(
        labels, torch.sigmoid(logits), weights, group)
    union = lab_sum + prob_sum
    coef = (2 * inter + smooth) / torch.clamp(union + smooth, min=_EPS)
    return torch.mean(1 - coef)


def jaccard_loss_masked(labels: Tensor, logits: Tensor, weights: Tensor,
                        smooth: float = 1.0, group=None) -> Tensor:
    inter, lab_sum, prob_sum = _masked_class_sums(
        labels, torch.sigmoid(logits), weights, group)
    union = lab_sum + prob_sum
    jaccard = (inter + smooth) / torch.clamp(union - inter + smooth,
                                             min=_EPS)
    return torch.mean((1 - jaccard) * smooth)


def fixed_iou_loss_masked(labels: Tensor, logits: Tensor, weights: Tensor,
                          smooth: float = 1e-7, group=None) -> Tensor:
    """The union counts false positives as (1 − labels)·probs."""
    probs = torch.sigmoid(logits)
    w = weights[..., None]
    inter = _leading_sum(labels * probs * w, group)
    union = (_leading_sum(labels * w, group)
             + _leading_sum((1 - labels) * probs * w, group))
    iou = (inter + smooth) / torch.clamp(union + smooth, min=_EPS)
    return torch.mean(1 - iou)


def balanced_bce_masked(labels: Tensor, logits: Tensor,
                        weights: Tensor, group=None) -> Tensor:
    """Per-class pos/neg frequency balancing over the global anchor axis,
    then the mean over weighted entries."""
    w = weights[..., None]
    num_pos = _leading_sum(labels * w, group)
    num_neg = _leading_sum((1 - labels) * w, group)
    total = torch.clamp(num_pos + num_neg, min=1.0)
    weight_pos = num_neg / total
    weight_neg = num_pos / total
    per_entry_w = torch.where(labels == 1, weight_pos, weight_neg)
    bce = sigmoid_bce_with_logits(labels, logits) * per_entry_w * w
    denom = torch.clamp(_global_sum(w * torch.ones_like(labels), group),
                        min=1.0)
    return _global_sum(bce, group) / denom


def huber_loss(labels: Tensor, predictions: Tensor,
               delta: float = 1.0) -> Tensor:
    """Elementwise Huber (tf.losses.huber_loss semantics)."""
    err = torch.abs(predictions - labels)
    quadratic = torch.clamp(err, max=delta)
    linear = err - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def regression_loss(labels: Tensor, logits: Tensor, fg_mask: Tensor,
                    delta: float = 1.0, group=None) -> Tensor:
    """Huber on foreground anchors, divided by the number of nonzero
    weight elements of the broadcast [..., 4] loss."""
    w = fg_mask.to(labels.dtype)[..., None]
    per_elem = huber_loss(labels, logits, delta) * w
    num_nonzero = _global_sum(w * torch.ones_like(labels), group)
    return _global_sum(per_elem, group) / torch.clamp(num_nonzero, min=1.0)


def classification_loss(labels: Tensor, logits: Tensor, weights: Tensor,
                        fg_mask: Tensor, cfg: LossConfig = LossConfig(),
                        group=None) -> Tensor:
    """Sum of the configured class-loss terms over weighted anchors:
    ``labels``/``logits`` [..., C], ``weights`` the trainable mask [...],
    ``fg_mask`` the foreground anchors [...] (focal's normalizer)."""
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    w = weights.to(logits.dtype)
    entry_count = torch.clamp(
        _global_sum(w[..., None] * torch.ones_like(labels), group), min=1.0)
    for name in cfg.class_losses:
        if name == "bce":
            bce = sigmoid_bce_with_logits(labels, logits) * w[..., None]
            total = total + _global_sum(bce, group) / entry_count
        elif name == "focal":
            focal = focal_sigmoid_bce_with_logits(
                labels, logits, focus=cfg.focal_gamma,
                alpha=cfg.focal_alpha) * w[..., None]
            num_fg = _global_sum(fg_mask.to(torch.float32), group)
            total = total + _global_sum(focal, group) / torch.clamp(
                num_fg, min=1.0)
        elif name == "dice":
            total = total + dice_loss_masked(
                labels, logits, w, smooth=cfg.dice_smooth, group=group)
        elif name == "jaccard":
            total = total + jaccard_loss_masked(
                labels, logits, w, smooth=cfg.jaccard_smooth, group=group)
        elif name == "fixed_iou":
            total = total + fixed_iou_loss_masked(labels, logits, w,
                                                  group=group)
        elif name == "balanced_bce":
            total = total + balanced_bce_masked(labels, logits, w, group)
        else:
            raise ValueError(f"unknown classification loss: {name}")
    return total


def detection_loss(class_targets: Tensor, class_logits: Tensor,
                   regression_targets: Tensor, regression_logits: Tensor,
                   trainable_mask: Tensor, cfg: LossConfig = LossConfig(),
                   group=None) -> Tuple[Tensor, Tensor]:
    """(class_loss, regression_loss) of the global batch: this rank's
    anchors, the sums over ``group``'s ranks (none when None).  Foreground
    anchors are those whose target class map has a value > 0.5 and that
    are trainable."""
    fg_mask = (torch.amax(class_targets, dim=-1) > 0.5) & trainable_mask
    class_loss = classification_loss(class_targets, class_logits,
                                     trainable_mask, fg_mask, cfg, group)
    regr_loss = regression_loss(regression_targets, regression_logits,
                                fg_mask, delta=cfg.huber_delta, group=group)
    return class_loss, regr_loss
