"""Box geometry (port of ``retinanet_tpu/ops/boxes.py``).

Corner boxes are ``[..., (t, l, b, r)]`` and center boxes
``[..., (cy, cx, h, w)]``, image-relative, exactly as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import Tensor


def from_center_box(box: Tensor) -> Tensor:
    """Center (cy,cx,h,w) → corner (t,l,b,r)."""
    pos, size = box.split(2, dim=-1)
    half = size / 2
    return torch.cat([pos - half, pos + half], dim=-1)


def iou(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise IoU of broadcast-compatible corner boxes; pairs that do
    not overlap, and degenerate pairs, give exactly 0."""
    y_top = torch.maximum(a[..., 0], b[..., 0])
    x_left = torch.maximum(a[..., 1], b[..., 1])
    y_bottom = torch.minimum(a[..., 2], b[..., 2])
    x_right = torch.minimum(a[..., 3], b[..., 3])

    inter_h = y_bottom - y_top
    inter_w = x_right - x_left
    invalid = (inter_h < 0) | (inter_w < 0)
    intersection = inter_h * inter_w

    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - intersection
    out = intersection / torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(invalid, torch.zeros_like(out), out)


def pairwise_iou(a: Tensor, b: Tensor) -> Tensor:
    """[..., N, 4] × [..., M, 4] → [..., N, M] IoU matrix."""
    return iou(a[..., :, None, :], b[..., None, :, :])
