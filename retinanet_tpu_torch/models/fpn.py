"""Feature Pyramid Network (port of ``retinanet_tpu/models/fpn.py``).

P6 = 3×3/2 ConvGN(C5); P7 = 3×3/2 ConvGN(act(P6)); P5 = 1×1 ConvGN(C5);
P4/P3 = lateral 1×1 ConvGN + nearest upsample + add + 3×3 ConvGN merge.
Submodule names follow flax's creation order: ``ConvGN_0`` = P6,
``ConvGN_1`` = P7, ``ConvGN_2`` = P5, ``UpsampleMerge_0`` = P4,
``UpsampleMerge_1`` = P3.  ``quantize`` makes all seven convs int8.
"""

from __future__ import annotations

from typing import Dict

from torch import Tensor, nn

from retinanet_tpu_torch.models.layers import (ConvGN, get_activation,
                                               nearest_upsample)


class UpsampleMerge(nn.Module):
    """lateral 1×1+GN; upsample; add; 3×3 merge+GN."""

    def __init__(self, in_channels: int, channels: int = 256,
                 quantize: bool = False):
        super().__init__()
        self.ConvGN_0 = ConvGN(in_channels, channels, kernel_size=1,
                               kernel_init="normal_001", quantize=quantize)
        self.ConvGN_1 = ConvGN(channels, channels, kernel_size=3,
                               kernel_init="normal_001", quantize=quantize)

    def forward(self, lateral: Tensor, downsampled: Tensor) -> Tensor:
        lateral = self.ConvGN_0(lateral)
        merged = lateral + nearest_upsample(downsampled, lateral.shape[2:])
        return self.ConvGN_1(merged)


class FPN(nn.Module):
    """{'C3','C4','C5'} → {'P3'..'P7'} at ``channels`` width."""

    def __init__(self, in_channels: Dict[str, int], channels: int = 256,
                 activation: str = "elu", quantize: bool = False):
        super().__init__()
        self.activation = activation
        q = dict(kernel_init="normal_001", quantize=quantize)
        self.ConvGN_0 = ConvGN(in_channels["C5"], channels, kernel_size=3,
                               strides=2, **q)
        self.ConvGN_1 = ConvGN(channels, channels, kernel_size=3, strides=2,
                               **q)
        self.ConvGN_2 = ConvGN(in_channels["C5"], channels, kernel_size=1,
                               **q)
        self.UpsampleMerge_0 = UpsampleMerge(in_channels["C4"], channels,
                                             quantize)
        self.UpsampleMerge_1 = UpsampleMerge(in_channels["C3"], channels,
                                             quantize)

    def forward(self, c: Dict[str, Tensor]) -> Dict[str, Tensor]:
        p6 = self.ConvGN_0(c["C5"])
        p7 = self.ConvGN_1(get_activation(self.activation)(p6))
        p5 = self.ConvGN_2(c["C5"])
        p4 = self.UpsampleMerge_0(c["C4"], p5)
        p3 = self.UpsampleMerge_1(c["C3"], p4)
        return {"P3": p3, "P4": p4, "P5": p5, "P6": p6, "P7": p7}
