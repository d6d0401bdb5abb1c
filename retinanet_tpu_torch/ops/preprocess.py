"""Image normalization (port of ``retinanet_tpu/ops/preprocess.py``)."""

from __future__ import annotations

import torch
from torch import Tensor

from retinanet_tpu_torch.config import DataConfig


def maybe_normalize(images: Tensor, data_cfg: DataConfig) -> Tensor:
    """uint8 [B,H,W,3] → normalized float32; float input passes through."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.tensor(data_cfg.mean, dtype=torch.float32,
                        device=images.device)
    std = torch.tensor(data_cfg.std, dtype=torch.float32,
                       device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std
