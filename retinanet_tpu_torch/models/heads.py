"""Shared classification / regression subnets (port of
``retinanet_tpu/models/heads.py``).

4 × (3×3 ConvGN 256 + act), then a biased 3×3 output conv whose
``[B, A·K, H, W]`` output is permuted to NHWC before it is viewed as
``[B, H, W, A, K]`` (channel a·K+k is anchor a, class k).  Logits stay in
the compute dtype at serving time and are float32 when training (the loss
reductions are precision-sensitive); the class bias starts at
−log((1−π)/π).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor, nn

from retinanet_tpu_torch.models.layers import Conv, ConvGN


class _Subnet(nn.Module):
    def __init__(self, out_per_anchor: int, num_anchors: int, channels: int,
                 depth: int, activation: str, bias_init: float):
        super().__init__()
        self.num_anchors = num_anchors
        self.out_per_anchor = out_per_anchor
        for i in range(depth):
            self.add_module(f"ConvGN_{i}", ConvGN(
                channels, channels, kernel_size=3, activation=activation,
                kernel_init="normal_001"))
        self.depth = depth
        self.Conv_0 = Conv(channels, num_anchors * out_per_anchor,
                           kernel_size=3, use_bias=True,
                           kernel_init="normal_001", bias_init=bias_init)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        for i in range(self.depth):
            x = getattr(self, f"ConvGN_{i}")(x)
        x = self.Conv_0(x)
        b, _, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(
            b, h, w, self.num_anchors, self.out_per_anchor)
        return x.to(torch.float32) if training else x


class ClassificationSubnet(_Subnet):
    def __init__(self, num_anchors: int, num_classes: int,
                 channels: int = 256, depth: int = 4,
                 activation: str = "elu", prior_prob: float = 0.01):
        super().__init__(num_classes, num_anchors, channels, depth,
                         activation,
                         -math.log((1 - prior_prob) / prior_prob))


class RegressionSubnet(_Subnet):
    def __init__(self, num_anchors: int, channels: int = 256, depth: int = 4,
                 activation: str = "elu"):
        super().__init__(4, num_anchors, channels, depth, activation, 0.0)
