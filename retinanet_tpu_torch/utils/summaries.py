"""Step diagnostics (port of ``retinanet_tpu/utils/summaries.py:
prob_histograms``): the fg/bg predicted-probability histograms over 20 fixed
bins in [0, 1], computed on the device.  The metrics writer comes with the
training loop's slice."""

from __future__ import annotations

from typing import Dict

import torch
from torch import Tensor

HIST_BINS = 20


def prob_histograms(class_targets: Tensor, class_probs: Tensor,
                    trainable_mask: Tensor) -> Dict[str, Tensor]:
    """Float32 counts of trainable (anchor, class) entries per probability
    bin, split by target 1 (fg) and 0 (bg).  One weighted ``bincount``
    each where the JAX package takes 20 masked sums: the counts are
    whole numbers either way."""
    w = trainable_mask.to(torch.float32)[..., None].expand_as(class_targets)
    bins = torch.clamp((class_probs * HIST_BINS).to(torch.int32), 0,
                       HIST_BINS - 1).reshape(-1).long()

    def hist(selected: Tensor) -> Tensor:
        weights = (w * selected).reshape(-1)
        return torch.bincount(bins, weights=weights,
                              minlength=HIST_BINS).to(torch.float32)

    return {"prob_fg_hist": hist(class_targets == 1),
            "prob_bg_hist": hist(class_targets == 0)}
