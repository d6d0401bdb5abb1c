"""ResNet-50 backbones (port of ``retinanet_tpu/models/resnet.py``): the
dense flagship (``ResNetBottleneck``, ``ResNet50``) and ResNeXt-50 32×4d
(``ResNeXtBottleneck``, ``ResNeXt50``, the ``resnet_50`` backbone).

Submodules carry flax's auto-numbered names (``ConvGN_0`` is the
projection when a block has one; blocks are ``ResNetBottleneck_0..15``
across all stages), so parameters load by flax leaf path whichever path
runs.  Stride-1 identity blocks in bf16 run the fused kernel B1
(``ops/bottleneck.py``) at serving time under the JAX package's gate, and
with ``fused_train`` every one of them runs B1 forward and the hand-written
backward B3 (``ops/bottleneck_bwd.py``) when training.  The JAX package
keeps res5 (width 20 at 640 px) on autodiff because of a Mosaic tiling
limit (``w % 8``); the CUDA kernel has none, so all 12 identity blocks take
B3.  With ``fused_proj`` the stride-1 projection block (res2 b0) serves
through kernel B5.  ``remat`` (``ModelConfig.remat``) runs every training
block that takes no kernel under ``torch.utils.checkpoint`` (the JAX
package's ``remat_call``): its backward recomputes the block instead of
keeping its activations.  B3's blocks already keep only their primals.
A fused block keeps its kernels' bf16 layouts per parameter version
(``ops/cuda.py:ParameterCache`` of ``ops/bottleneck.py:prepare_weights`` or
``prepare_proj_weights``): built once for serving, and again after every
optimizer step in training.  ``quantize`` runs every block conv through
the int8 convolution (kernel B6) and keeps every block off B1, B3 and B5;
the stem stays float.  Everything else runs the plain layers.

ResNeXt-50 keeps the reference's quirks, as the JAX package does: the
downsampling projection is a 3×3 stride-2 ConvGN, the stride sits on the
grouped 3×3, block activations are relu whatever the model's activation,
and the grouped conv's GroupNorm has one group per channel.  Its grouped
3×3 runs block-diagonal dense up to width 512 and truly grouped at 1024
(``Conv.grouped_as_dense``); it takes no fused kernel and has no dropout.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint

from retinanet_tpu_torch.models.layers import (Conv, ConvGN, DropoutKeys,
                                               GroupNorm, max_pool_same)
from retinanet_tpu_torch.ops.bottleneck import (fused_bottleneck,
                                                fused_bottleneck_proj,
                                                prepare_proj_weights,
                                                prepare_weights)
from retinanet_tpu_torch.ops.bottleneck_bwd import fused_bottleneck_train
from retinanet_tpu_torch.ops.cuda import ParameterCache

logger = logging.getLogger(__name__)


def remat_call(block: nn.Module, x: Tensor, training: bool, enabled: bool,
               keys: Optional[DropoutKeys] = None) -> Tensor:
    """``block(x, training, keys)``, under ``torch.utils.checkpoint`` when
    ``enabled`` and training (the JAX package's ``remat_call``): the
    backward recomputes the block instead of keeping its activations.
    Dropout masks repeat in the recomputation (``DropoutKeys``)."""
    if enabled and training:
        return checkpoint(block, x, training, keys, use_reentrant=False)
    return block(x, training, keys)


class ResNetBottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride on the 3×3) → 1×1 expand, GN + relu."""

    def __init__(self, in_channels: int, filters: int,
                 project: Union[bool, str], fused: bool = False,
                 fused_train: bool = False, fused_proj: bool = False,
                 quantize: bool = False):
        super().__init__()
        self.filters = filters
        self.project = project
        self.fused = fused
        self.fused_train = fused_train
        self.fused_proj = fused_proj
        self.quantize = quantize
        strides = 2 if project == "down" else 1
        convs = []
        if project:
            convs.append(ConvGN(in_channels, filters * 4, kernel_size=1,
                                strides=strides, quantize=quantize))
        convs += [ConvGN(in_channels, filters, kernel_size=1,
                         activation="relu", quantize=quantize),
                  ConvGN(filters, filters, kernel_size=3, strides=strides,
                         activation="relu", quantize=quantize),
                  ConvGN(filters, filters * 4, kernel_size=1,
                         quantize=quantize)]
        for i, conv in enumerate(convs):
            self.add_module(f"ConvGN_{i}", conv)
        self._fused_weights: Optional[ParameterCache] = None

    def _kernel(self, x: Tensor, training: bool):
        """The fused block function this call takes (B1, B3 or B5), or
        None for the plain layers."""
        bf16 = x.dtype == torch.bfloat16 and not self.quantize
        if self.project:  # B5: the stride-1 projection block, serving only
            fused = (bf16 and self.project is True and self.fused_proj
                     and not training)
            return fused_bottleneck_proj if fused else None
        fused = (bf16 and x.shape[1] == self.filters * 4
                 and (self.fused_train if training else self.fused))
        if not fused:
            return None
        return fused_bottleneck_train if training else fused_bottleneck

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        convs = list(self.children())
        conv1, conv2, conv3 = convs[-3:]
        block = self._kernel(x, training)
        if block is not None:
            # B5 takes the projection's parameters last.
            order = convs[1:] + convs[:1] if self.project else convs
            params = []
            for conv in order:
                params += [conv.Conv_0.kernel, conv.GroupNorm_0.gamma,
                           conv.GroupNorm_0.beta]
            if self._fused_weights is None:
                self._fused_weights = ParameterCache(
                    prepare_proj_weights if self.project else prepare_weights)
            weights = self._fused_weights(*params[::3])
            out = block(x.permute(0, 2, 3, 1), *params, weights=weights)
            return out.permute(0, 3, 1, 2)
        identity = convs[0](x) if self.project else x
        return F.relu(conv3(conv2(conv1(x))) + identity)


class ResNet50(nn.Module):
    """Dense ResNet-50 returning {'C1'..'C5'}: 7×7/2 stem ConvGN + relu
    (never quantized), 3×3/2 SAME max pool, stages (64,3) (128,4) (256,6)
    (512,3).  ``remat``: training blocks off the kernels run under
    ``checkpoint`` (parameter names unchanged)."""

    STAGES = ((64, 3, False), (128, 4, True), (256, 6, True), (512, 3, True))
    channels = {"C1": 64, "C2": 256, "C3": 512, "C4": 1024, "C5": 2048}

    def __init__(self, fused_blocks: bool = False, fused_res2: bool = False,
                 fused_res2_strips: int = 20, fused_res3_strips: int = 0,
                 fused_res4_strips: int = 0, fused_train: bool = False,
                 fused_proj: bool = False, quantize: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if fused_blocks and (fused_res2_strips or fused_res3_strips
                             or fused_res4_strips):
            logger.info("fused_res{2,3,4}_strips size TPU VMEM strips; the "
                        "CUDA bottleneck kernel ignores them")
        self.ConvGN_0 = ConvGN(3, 64, kernel_size=7, strides=2,
                               activation="relu")
        in_ch, idx = 64, 0
        for filters, depth, downsample in self.STAGES:
            for i in range(depth):
                project = ("down" if downsample else True) if i == 0 else False
                block = ResNetBottleneck(
                    in_ch, filters, project,
                    fused=fused_blocks and (filters >= 128 or fused_res2),
                    fused_train=fused_train, fused_proj=fused_proj,
                    quantize=quantize)
                self.add_module(f"ResNetBottleneck_{idx}", block)
                in_ch, idx = filters * 4, idx + 1

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Dict[str, Tensor]:
        x = self.ConvGN_0(x)
        taps = {"C1": x}
        x = max_pool_same(x, 3, 2)
        idx = 0
        for stage_idx, (_, depth, _) in enumerate(self.STAGES):
            for _ in range(depth):
                block = getattr(self, f"ResNetBottleneck_{idx}")
                x = remat_call(block, x, training, self.remat and
                               block._kernel(x, training) is None)
                idx += 1
            taps[f"C{stage_idx + 2}"] = x
        return taps


class ResNeXtBottleneck(nn.Module):
    """Grouped bottleneck (the reference's ``ResNeXt_Bottleneck``): an
    optional projection, 1×1 to width 2·filters + relu, the grouped 3×3
    (cardinality 32, stride 2 on "down" blocks) + per-channel GN + relu,
    1×1 to 4·filters, relu of the sum.  Parameter names in flax's
    creation order: ``ConvGN_0`` is the projection where there is one."""

    def __init__(self, in_channels: int, filters: int,
                 project: Union[bool, str], cardinality: int = 32,
                 quantize: bool = False):
        super().__init__()
        self.project = project
        width = filters * 2
        strides = 2 if project == "down" else 1
        convs = []
        if project:
            # Reference quirk: the "down" projection is 3×3/2.
            convs.append(ConvGN(in_channels, filters * 4,
                                kernel_size=3 if project == "down" else 1,
                                strides=strides, quantize=quantize))
        convs.append(ConvGN(in_channels, width, kernel_size=1,
                            activation="relu", quantize=quantize))
        for i, conv in enumerate(convs):
            self.add_module(f"ConvGN_{i}", conv)
        self.Conv_0 = Conv(width, width, kernel_size=3, strides=strides,
                           quantize=quantize,
                           feature_group_count=cardinality,
                           grouped_as_dense=width <= 512)
        self.GroupNorm_0 = GroupNorm(width, groups=width, activation="relu")
        self.add_module(f"ConvGN_{len(convs)}", ConvGN(
            width, filters * 4, kernel_size=1, quantize=quantize))

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Tensor:
        n = 1 if self.project else 0
        identity = self.ConvGN_0(x) if self.project else x
        y = getattr(self, f"ConvGN_{n}")(x)
        y = self.GroupNorm_0(self.Conv_0(y))
        y = getattr(self, f"ConvGN_{n + 1}")(y)
        return F.relu(y + identity)


class ResNeXt50(nn.Module):
    """ResNeXt-50 32×4d returning {'C1'..'C5'}: the dense model's stem
    (7×7/2 ConvGN + relu, never quantized, then the 3×3/2 max pool) and
    stage layout, with ``ResNeXtBottleneck_0..15``.  ``remat`` runs every
    training block under ``checkpoint``."""

    STAGES = ResNet50.STAGES
    channels = ResNet50.channels

    def __init__(self, quantize: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.ConvGN_0 = ConvGN(3, 64, kernel_size=7, strides=2,
                               activation="relu")
        in_ch, idx = 64, 0
        for filters, depth, downsample in self.STAGES:
            for i in range(depth):
                project = ("down" if downsample else True) if i == 0 else False
                self.add_module(f"ResNeXtBottleneck_{idx}", ResNeXtBottleneck(
                    in_ch, filters, project, quantize=quantize))
                in_ch, idx = filters * 4, idx + 1

    def forward(self, x: Tensor, training: bool = False,
                keys: Optional[DropoutKeys] = None) -> Dict[str, Tensor]:
        x = self.ConvGN_0(x)
        taps = {"C1": x}
        x = max_pool_same(x, 3, 2)
        idx = 0
        for stage_idx, (_, depth, _) in enumerate(self.STAGES):
            for _ in range(depth):
                x = remat_call(getattr(self, f"ResNeXtBottleneck_{idx}"), x,
                               training, self.remat)
                idx += 1
            taps[f"C{stage_idx + 2}"] = x
        return taps
