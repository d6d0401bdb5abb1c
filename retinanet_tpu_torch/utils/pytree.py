"""Level flattening (port of ``retinanet_tpu/utils/pytree.py:flatten_levels``).

Per-level maps ``[..., H, W, A, T]`` (or ``[..., H, W, A]`` masks) are
concatenated in the canonical level order into ``[..., N_total(, T)]``, the
flat anchor axis the losses weight by the trainable mask.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import Tensor

LEVEL_ORDER = ("P3", "P4", "P5", "P6", "P7")


def sorted_levels(d: Dict[str, Tensor]) -> List[str]:
    return [k for k in LEVEL_ORDER if k in d]


def flatten_levels(d: Dict[str, Tensor], batch_dims: int = 1) -> Tensor:
    """Concat per-level maps [..., H, W, A, T] → [..., N_total, T]
    ([..., H, W, A] masks → [..., N_total])."""
    flat = []
    for k in sorted_levels(d):
        v = d[k]
        lead = v.shape[:batch_dims]
        trail = v.shape[batch_dims:]
        if len(trail) == 3:
            flat.append(v.reshape(*lead, -1))
        else:
            flat.append(v.reshape(*lead, -1, trail[-1]))
    return torch.cat(flat, dim=batch_dims)
