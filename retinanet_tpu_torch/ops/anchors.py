"""Anchor pyramid (the port's copy of ``retinanet_tpu/ops/anchors.py``).

P3..P7 with base sizes 32/64/128/256/512 px, 3 aspect ratios × 3 scale
ratios = 9 anchors per cell; ``compute_box_size`` preserves area under the
aspect ratio.  Plain numpy, computed once per canvas.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, Tuple

import numpy as np

from retinanet_tpu_torch.config import AnchorConfig


def image_hw(image_size) -> Tuple[int, int]:
    """(h, w) of a canvas spec: an int (square) or an (h, w) pair."""
    if isinstance(image_size, (tuple, list)):
        h, w = image_size
        return int(h), int(w)
    return int(image_size), int(image_size)


def compute_box_size(base_size: float, aspect_ratio: Tuple[float, float],
                     scale_ratio: float) -> np.ndarray:
    """(h, w) with h*w == base_size**2 * scale_ratio**2 and w/h == ar[1]/ar[0]."""
    ar = np.asarray(aspect_ratio, dtype=np.float64)
    return np.sqrt(base_size ** 2 / ar.prod()) * ar * scale_ratio


class Level:
    """One pyramid level's anchor set."""

    def __init__(self, anchor_size: float,
                 aspect_ratios: Tuple[Tuple[float, float], ...],
                 scale_ratios: Tuple[float, ...]):
        self._anchor_size = anchor_size
        self._aspect_ratios = tuple(aspect_ratios)
        self._scale_ratios = tuple(scale_ratios)

    @property
    def anchor_sizes(self) -> np.ndarray:
        """[A, 2] anchor (h, w) in pixels."""
        return np.stack([
            compute_box_size(self._anchor_size, ar, sr)
            for ar, sr in product(self._aspect_ratios, self._scale_ratios)
        ], axis=0)


class Levels:
    """Dict-like P3..P7 pyramid."""

    def __init__(self, config: AnchorConfig = AnchorConfig()):
        self.config = config
        self._levels: Dict[str, Level] = {
            f"P{k}": Level(
                config.base_size * 2 ** (k - config.min_level),
                config.aspect_ratios, config.scale_ratios)
            for k in config.levels
        }

    @property
    def num_anchors(self) -> int:
        return self.config.num_anchors

    def keys(self):
        return self._levels.keys()

    def __getitem__(self, key: str) -> Level:
        return self._levels[key]

    def __iter__(self):
        return iter(self._levels)

    def items(self):
        return self._levels.items()

    @staticmethod
    def stride(level_name: str) -> int:
        """Feature stride of a level: 2**k."""
        return 2 ** int(level_name[-1])

    def grid_size(self, level_name: str, image_size: int) -> int:
        return math.ceil(image_size / self.stride(level_name))

    def grid_hw(self, level_name: str, image_size) -> Tuple[int, int]:
        """(grid_h, grid_w) for a square or rectangular canvas."""
        h, w = image_hw(image_size)
        s = self.stride(level_name)
        return math.ceil(h / s), math.ceil(w / s)

    def normalized_anchor_sizes(self, level_name: str,
                                image_size) -> np.ndarray:
        """[A, 2] anchor sizes divided by the canvas side of each
        dimension (canvas-relative units)."""
        hw = np.asarray(image_hw(image_size), np.float64)
        return (self[level_name].anchor_sizes / hw).astype(np.float32)


def flat_anchor_maps(levels: Levels, image_size) -> np.ndarray:
    """[N_total, 4] (cy, cx, h, w) of every anchor across all levels,
    canvas-relative, concatenated in sorted level-name order: the flat
    candidate space of ``utils.pytree.flatten_levels`` and the decode."""
    maps = {}
    for pn in levels:
        gh, gw = levels.grid_hw(pn, image_size)
        gy = (np.arange(gh, dtype=np.float32) + 0.5) / gh
        gx = (np.arange(gw, dtype=np.float32) + 0.5) / gw
        grid = np.stack(np.meshgrid(gy, gx, indexing="ij"),
                        axis=-1)[:, :, None, :]
        sizes = levels.normalized_anchor_sizes(pn, image_size)
        a = sizes.shape[0]
        pos = np.broadcast_to(grid, (gh, gw, a, 2))
        size = np.broadcast_to(sizes[None, None], (gh, gw, a, 2))
        maps[pn] = np.concatenate([pos, size], -1).astype(np.float32)
    return np.concatenate([maps[pn].reshape(-1, 4) for pn in sorted(maps)],
                          axis=0)


def build_levels(config: AnchorConfig = AnchorConfig()) -> Levels:
    """Default 3 aspect ratios × 3 scales = 9 anchors per cell."""
    return Levels(config)
