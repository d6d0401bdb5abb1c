"""MobileNetV2 backbone (port of ``retinanet_tpu/models/mobilenet_v2.py``).

The reference's variant, as the JAX package keeps it: GroupNorm (and
dropout) after every conv, the model's activation instead of relu6, an
expand 1×1 even at expansion 1, and a 32-wide 1×1 output ConvGN for C5.
The depthwise 3×3 (``feature_group_count`` = channels) stays a float
``F.conv2d`` under int8 serving, as do the stem and the C5 conv; every
other 1×1 runs on kernel B6 there.  GroupNorm groups come from
``resolve_groups`` (144 channels → 24 groups).
"""

from __future__ import annotations

from typing import Dict, Optional

from torch import Tensor, nn

from retinanet_tpu_torch.models.layers import (Conv, ConvGN, Dropout,
                                               DropoutKeys, GroupNorm)
from retinanet_tpu_torch.models.resnet import remat_call

# (filters, expansion, stride, repeats) per stage.
STAGES = (
    (16, 1, 1, 1),
    (24, 6, 2, 2),
    (32, 6, 2, 3),
    (64, 6, 2, 4),
    (96, 6, 1, 3),
    (160, 6, 2, 3),
    (320, 6, 1, 1),
)
# C-level taps after stages 0, 1, 2 and 4; C5 is the output conv.
TAPS = {0: "C1", 1: "C2", 2: "C3", 4: "C4"}


class Bottleneck(nn.Module):
    """Inverted residual: expand 1×1 ConvGN + act + dropout, depthwise 3×3
    (never quantized) + GN + act + dropout, linear 1×1 ConvGN + dropout;
    the input is added back where the shapes match."""

    def __init__(self, in_channels: int, filters: int, strides: int,
                 expansion: int, activation: str, dropout_rate: float,
                 quantize: bool = False):
        super().__init__()
        ch = in_channels * expansion
        self.ConvGN_0 = ConvGN(in_channels, ch, kernel_size=1,
                               activation=activation,
                               dropout_rate=dropout_rate, quantize=quantize)
        self.Conv_0 = Conv(ch, ch, kernel_size=3, strides=strides,
                           feature_group_count=ch)
        self.GroupNorm_0 = GroupNorm(ch, activation=activation)
        self.dropout = Dropout(dropout_rate)
        self.ConvGN_1 = ConvGN(ch, filters, kernel_size=1,
                               dropout_rate=dropout_rate, quantize=quantize)

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        y = self.ConvGN_0(x, training, keys)
        y = self.dropout(self.GroupNorm_0(self.Conv_0(y)), training, keys)
        y = self.ConvGN_1(y, training, keys)
        return y + x if y.shape == x.shape else y


class MobileNetV2(nn.Module):
    """Returns {'C1'..'C5'}: a 3×3/2 stem ConvGN (32) + act + dropout, the
    17 ``Bottleneck_i`` of ``STAGES``, and the 32-wide C5 ConvGN."""

    channels = {"C1": 16, "C2": 24, "C3": 32, "C4": 96, "C5": 32}

    def __init__(self, activation: str = "elu", dropout_rate: float = 0.2,
                 quantize: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.ConvGN_0 = ConvGN(3, 32, kernel_size=3, strides=2,
                               activation=activation,
                               dropout_rate=dropout_rate)
        in_ch, idx = 32, 0
        self.stage_ends = []
        for filters, expansion, stride, repeats in STAGES:
            for r in range(repeats):
                self.add_module(f"Bottleneck_{idx}", Bottleneck(
                    in_ch, filters, stride if r == 0 else 1, expansion,
                    activation, dropout_rate, quantize))
                in_ch, idx = filters, idx + 1
            self.stage_ends.append(idx)
        self.ConvGN_1 = ConvGN(in_ch, 32, kernel_size=1,
                               activation=activation,
                               dropout_rate=dropout_rate)

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Dict[str, Tensor]:
        x = self.ConvGN_0(x, training, keys)
        taps: Dict[str, Tensor] = {}
        idx = 0
        for stage, end in enumerate(self.stage_ends):
            while idx < end:
                x = remat_call(getattr(self, f"Bottleneck_{idx}"), x,
                               training, self.remat, keys)
                idx += 1
            if stage in TAPS:
                taps[TAPS[stage]] = x
        taps["C5"] = self.ConvGN_1(x, training, keys)
        return taps
