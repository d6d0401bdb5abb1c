"""DenseNet-BC 121/169 backbones (port of
``retinanet_tpu/models/densenet.py``).

Pre-activation composites (GN → act → 1×1 (4k) → dropout → GN → act → 3×3
(k) → dropout), concatenative growth k = 32, compression-0.5 transitions
(GN without activation → 1×1 → dropout → 2×2/2 SAME average pool).  Block
depths: 121 → (6, 12, 24, 16); 169 → (6, 12, 32, 32).  C2..C5 are taken
before each transition, so C5 carries raw pre-activation features, as in
the JAX package.  The 7×7/2 stem conv stays float under int8 serving;
every composite and transition conv runs on kernel B6 there.  ``remat``
runs each training composite under ``checkpoint``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import Tensor, nn

from retinanet_tpu_torch.models.layers import (Conv, Dropout, DropoutKeys,
                                               GroupNorm, avg_pool_same,
                                               max_pool_same)
from retinanet_tpu_torch.models.resnet import remat_call


class BottleneckComposite(nn.Module):
    """GN→act→1×1(4k)→drop→GN→act→3×3(k)→drop."""

    def __init__(self, in_channels: int, growth_rate: int, activation: str,
                 dropout_rate: float, quantize: bool = False):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(in_channels, activation=activation)
        self.Conv_0 = Conv(in_channels, 4 * growth_rate, kernel_size=1,
                           quantize=quantize)
        self.dropout_0 = Dropout(dropout_rate)
        self.GroupNorm_1 = GroupNorm(4 * growth_rate, activation=activation)
        self.Conv_1 = Conv(4 * growth_rate, growth_rate, kernel_size=3,
                           quantize=quantize)
        self.dropout_1 = Dropout(dropout_rate)

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        x = self.dropout_0(self.Conv_0(self.GroupNorm_0(x)), training, keys)
        return self.dropout_1(self.Conv_1(self.GroupNorm_1(x)), training,
                              keys)


class DenseBlock(nn.Module):
    """``depth`` composites, each one's output concatenated to its input
    along channels."""

    def __init__(self, in_channels: int, growth_rate: int, depth: int,
                 activation: str, dropout_rate: float, remat: bool = False,
                 quantize: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        for i in range(depth):
            self.add_module(f"BottleneckComposite_{i}", BottleneckComposite(
                in_channels + i * growth_rate, growth_rate, activation,
                dropout_rate, quantize))
        self.out_channels = in_channels + depth * growth_rate

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        for i in range(self.depth):
            out = remat_call(getattr(self, f"BottleneckComposite_{i}"), x,
                             training, self.remat, keys)
            x = torch.cat([x, out], dim=1)
        return x


class TransitionLayer(nn.Module):
    """GN (no activation) → 1×1 compress → dropout → 2×2/2 avg pool."""

    def __init__(self, in_channels: int, compression_factor: float,
                 dropout_rate: float, quantize: bool = False):
        super().__init__()
        self.out_channels = int(in_channels * compression_factor)
        self.GroupNorm_0 = GroupNorm(in_channels)
        self.Conv_0 = Conv(in_channels, self.out_channels, kernel_size=1,
                           quantize=quantize)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        x = self.dropout(self.Conv_0(self.GroupNorm_0(x)), training, keys)
        return avg_pool_same(x, 2, 2)


class DenseNetBC(nn.Module):
    """Returns {'C1'..'C5'}: 7×7/2 conv (2k) + GN + act → C1, 3×3/2 max
    pool, then ``DenseBlock_i`` (tapped as C(i+2)) and
    ``TransitionLayer_i`` between them."""

    def __init__(self, blocks: Sequence[int], growth_rate: int = 32,
                 compression_factor: float = 0.5, activation: str = "elu",
                 dropout_rate: float = 0.2, remat: bool = False,
                 quantize: bool = False):
        super().__init__()
        self.blocks = tuple(blocks)
        ch = 2 * growth_rate
        self.Conv_0 = Conv(3, ch, kernel_size=7, strides=2)
        self.GroupNorm_0 = GroupNorm(ch, activation=activation)
        self.channels = {"C1": ch}
        for i, depth in enumerate(self.blocks):
            block = DenseBlock(ch, growth_rate, depth, activation,
                               dropout_rate, remat, quantize)
            self.add_module(f"DenseBlock_{i}", block)
            ch = block.out_channels
            self.channels[f"C{i + 2}"] = ch
            if i < len(self.blocks) - 1:
                trans = TransitionLayer(ch, compression_factor, dropout_rate,
                                        quantize)
                self.add_module(f"TransitionLayer_{i}", trans)
                ch = trans.out_channels

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Dict[str, Tensor]:
        x = self.GroupNorm_0(self.Conv_0(x))
        taps = {"C1": x}
        x = max_pool_same(x, 3, 2)
        for i in range(len(self.blocks)):
            x = getattr(self, f"DenseBlock_{i}")(x, training, keys)
            taps[f"C{i + 2}"] = x
            if i < len(self.blocks) - 1:
                x = getattr(self, f"TransitionLayer_{i}")(x, training, keys)
        return taps


def DenseNetBC121(**kw) -> DenseNetBC:
    return DenseNetBC(blocks=(6, 12, 24, 16), **kw)


def DenseNetBC169(**kw) -> DenseNetBC:
    return DenseNetBC(blocks=(6, 12, 32, 32), **kw)
