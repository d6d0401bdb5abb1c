"""Step diagnostics and the metrics sink (port of
``retinanet_tpu/utils/summaries.py``): the fg/bg predicted-probability
histograms over 20 fixed bins in [0, 1], computed on the device, and
``MetricsWriter``, which appends each logged step to ``metrics.jsonl`` and
to a TensorBoard event file (``utils/tb_events.py``)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
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


def to_host(metrics: Mapping[str, object]) -> Dict[str, object]:
    """Metrics with every tensor as a numpy array: the tensors of each
    device cross to the host in one copy (one synchronisation), in float64,
    which holds float32 values and integer counts exactly."""
    out = dict(metrics)
    by_device: Dict[torch.device, list] = {}
    for key, value in metrics.items():
        if isinstance(value, Tensor):
            by_device.setdefault(value.device, []).append(key)
    for device, keys in by_device.items():
        flat = torch.cat([metrics[k].detach().reshape(-1).to(torch.float64)
                          for k in keys]).cpu().numpy()
        start = 0
        for k in keys:
            shape = tuple(metrics[k].shape)
            size = int(np.prod(shape))
            out[k] = flat[start:start + size].reshape(shape)
            start += size
    return out


class MetricsWriter:
    """Metrics sink: JSONL (greppable) + native TensorBoard event files.

    Scalars land in both; ``*_hist`` arrays (the fixed-20-bin fg/bg prob
    counts) become TensorBoard histograms.  Values may be tensors on any
    device, numpy arrays or Python numbers; a step's tensors are moved to
    the host together (``to_host``).
    """

    def __init__(self, experiment_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = True):
        os.makedirs(experiment_dir, exist_ok=True)
        self._path = os.path.join(experiment_dir, filename)
        self._file = open(self._path, "a")
        self._tb = None
        if tensorboard:
            from retinanet_tpu_torch.utils.tb_events import TBEventWriter
            self._tb = TBEventWriter(experiment_dir)

    def write(self, step: int, metrics: Mapping[str, object],
              prefix: Optional[str] = None):
        record = {"step": int(step), "time": time.time()}
        scalars, hists = {}, {}
        for k, v in to_host(metrics).items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, np.ndarray):
                record[key] = v.tolist() if v.ndim else float(v)
            else:
                record[key] = v
            if isinstance(record[key], float):
                scalars[key] = record[key]
            elif key.endswith("_hist") and np.ndim(record[key]) == 1:
                hists[key] = np.asarray(record[key], np.float64)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalars(scalars, step)
            for key, counts in hists.items():
                limits = np.linspace(1.0 / len(counts), 1.0, len(counts))
                self._tb.add_histogram_counts(key, counts, limits, step)

    def add_image_png(self, tag: str, png_bytes: bytes, height: int,
                      width: int, step: int):
        if self._tb is not None:
            self._tb.add_image_png(tag, png_bytes, height, width, step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
