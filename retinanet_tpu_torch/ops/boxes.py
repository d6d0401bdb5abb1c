"""Box geometry (port of ``retinanet_tpu/ops/boxes.py``).

Corner boxes are ``[..., (t, l, b, r)]`` and center boxes
``[..., (cy, cx, h, w)]``, image-relative, exactly as in the JAX package;
regression targets are ``(dy, dx, log_h, log_w)`` relative to the anchor.
"""

from __future__ import annotations

import torch
from torch import Tensor


def to_center_box(box: Tensor) -> Tensor:
    """Corner (t,l,b,r) → center (cy,cx,h,w)."""
    tl, br = box.split(2, dim=-1)
    size = br - tl
    return torch.cat([tl + size / 2, size], dim=-1)


def from_center_box(box: Tensor) -> Tensor:
    """Center (cy,cx,h,w) → corner (t,l,b,r)."""
    pos, size = box.split(2, dim=-1)
    half = size / 2
    return torch.cat([pos - half, pos + half], dim=-1)


def position_grid(height: int, width: int, dtype: torch.dtype = torch.float32,
                  device=None) -> Tensor:
    """[H, W, 2] cell-centre (y, x) positions ``(i + 0.5) / n`` in [0, 1]."""
    y = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    x = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([yy, xx], dim=-1)


def regression_postprocess(regression: Tensor, anchor_sizes: Tensor
                           ) -> Tensor:
    """Raw [..., H, W, A, 4] (dy, dx, log_h, log_w) maps → corner boxes:
    exp the sizes, scale by the [A, 2] normalized anchor sizes, add the grid
    centres, convert to corners."""
    shifts, log_scales = regression.split(2, dim=-1)
    decoded = torch.cat([shifts, torch.exp(log_scales)], dim=-1)
    decoded = decoded * anchor_sizes.to(decoded.dtype).repeat(1, 2)
    h, w = regression.shape[-4], regression.shape[-3]
    grid = position_grid(h, w, decoded.dtype, decoded.device)[:, :, None, :]
    pos, size = decoded.split(2, dim=-1)
    return from_center_box(torch.cat([pos + grid, size], dim=-1))


def encode_boxes(true_center_boxes: Tensor, anchor_positions: Tensor,
                 anchor_sizes: Tensor) -> Tensor:
    """Regression targets of center-form GT boxes against anchors:
    ``(pos − anchor_pos) / anchor_size`` and ``log(size / anchor_size)``;
    the arguments broadcast."""
    true_pos, true_size = true_center_boxes.split(2, dim=-1)
    shifts = (true_pos - anchor_positions) / anchor_sizes
    scales = true_size / anchor_sizes
    return torch.cat([shifts, torch.log(scales)], dim=-1)


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
