"""RetinaNet assembly (port of ``retinanet_tpu/models/retinanet.py``).

backbone → FPN → shared classification/regression subnets on P3..P7.
Images come in NHWC (the JAX layout) and are viewed as NCHW in
``channels_last`` memory; outputs are ``{'classifications': {P3..P7:
[B,H,W,A,K]}, 'regressions': {P3..P7: [B,H,W,A,4]}}`` in the compute
dtype (float32 logits when training).  ``l2_regularization`` is the
TF-parity L2 loss over the conv kernels.  Five backbones build:
``resnet_50`` (ResNeXt-50 32×4d, the default), ``resnet_50_dense`` (the
flagship, the only one with fused kernels), ``mobilenet_v2``,
``densenet_121`` and ``densenet_169``; each states its C1..C5 widths,
which size the FPN's inputs.  ``quantize="int8"`` serves any of them with
int8 backbone and FPN convs (heads, stems and depthwise convs float) on
the float model's parameters.  MobileNetV2 and DenseNet train with
dropout, drawn from the generator passed to ``forward``.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import Tensor, nn

from retinanet_tpu_torch.config import ModelConfig
from retinanet_tpu_torch.models.densenet import DenseNetBC121, DenseNetBC169
from retinanet_tpu_torch.models.fpn import FPN
from retinanet_tpu_torch.models.heads import (ClassificationSubnet,
                                              RegressionSubnet)
from retinanet_tpu_torch.models.layers import Dropout, DropoutKeys
from retinanet_tpu_torch.models.mobilenet_v2 import MobileNetV2
from retinanet_tpu_torch.models.resnet import ResNet50, ResNeXt50

logger = logging.getLogger(__name__)

BACKBONES = ("resnet_50", "resnet_50_dense", "densenet_121", "densenet_169",
             "mobilenet_v2")


def build_backbone(name: str, quantize: bool = False,
                   fused_blocks: bool = False, fused_res2: bool = False,
                   fused_res2_strips: int = 20, fused_res3_strips: int = 0,
                   fused_res4_strips: int = 0, fused_proj: bool = False,
                   fused_train: bool = False, remat: bool = False,
                   activation: str = "elu", dropout_rate: float = 0.0
                   ) -> nn.Module:
    """The backbone ``name`` (the JAX package's ``build_backbone``).  The
    ``fused_*`` flags reach only ``resnet_50_dense``; elsewhere they do
    nothing, as in the JAX package, and one line says so.  ResNet-50's
    two forms have no dropout and relu blocks whatever ``activation``."""
    if name == "resnet_50_dense":
        return ResNet50(fused_blocks=fused_blocks, fused_res2=fused_res2,
                        fused_res2_strips=fused_res2_strips,
                        fused_res3_strips=fused_res3_strips,
                        fused_res4_strips=fused_res4_strips,
                        fused_train=fused_train, fused_proj=fused_proj,
                        quantize=quantize, remat=remat)
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; choose from "
                         f"{BACKBONES}")
    fused = [flag for flag, on in (("fused_blocks", fused_blocks),
                                   ("fused_res2", fused_res2),
                                   ("fused_proj", fused_proj),
                                   ("fused_train", fused_train)) if on]
    if fused:
        logger.info("%s has no effect on backbone %r (resnet_50_dense "
                    "only)", ", ".join(fused), name)
    if name == "resnet_50":
        return ResNeXt50(quantize=quantize, remat=remat)
    if name == "mobilenet_v2":
        return MobileNetV2(activation, dropout_rate, quantize=quantize,
                           remat=remat)
    factory = DenseNetBC121 if name == "densenet_121" else DenseNetBC169
    return factory(activation=activation, dropout_rate=dropout_rate,
                   remat=remat, quantize=quantize)


class RetinaNet(nn.Module):
    """Full detector.  Construct via ``RetinaNet.from_config(cfg.model)``."""

    def __init__(self, backbone: str = "resnet_50",
                 num_classes: int = 80, num_anchors: int = 9,
                 activation: str = "elu", dropout_rate: float = 0.2,
                 fpn_channels: int = 256,
                 head_depth: int = 4, prior_prob: float = 0.01,
                 quantize: bool = False, fused_blocks: bool = False,
                 fused_res2: bool = False, fused_res2_strips: int = 20,
                 fused_res3_strips: int = 0, fused_res4_strips: int = 0,
                 fused_proj: bool = False, fused_train: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.dtype = dtype
        self.backbone_net = build_backbone(
            backbone, quantize=quantize, fused_blocks=fused_blocks,
            fused_res2=fused_res2, fused_res2_strips=fused_res2_strips,
            fused_res3_strips=fused_res3_strips,
            fused_res4_strips=fused_res4_strips, fused_proj=fused_proj,
            fused_train=fused_train, remat=remat, activation=activation,
            dropout_rate=dropout_rate)
        self.fpn = FPN(self.backbone_net.channels, fpn_channels, activation,
                       quantize)
        # The heads stay float under int8 serving (retinanet.py:150-165).
        self.classification_subnet = ClassificationSubnet(
            num_anchors, num_classes, fpn_channels, head_depth, activation,
            prior_prob)
        self.regression_subnet = RegressionSubnet(
            num_anchors, fpn_channels, head_depth, activation)
        # Each dropout's index folds into the forward's seed.
        self.dropout_sites = [m for m in self.modules()
                              if isinstance(m, Dropout) and m.rate > 0]
        for site, module in enumerate(self.dropout_sites):
            module.site = site

    @classmethod
    def from_config(cls, cfg: ModelConfig, num_anchors: int = 9,
                    num_classes: int = None) -> "RetinaNet":
        return cls(
            backbone=cfg.backbone,
            num_classes=cfg.num_classes if num_classes is None
            else num_classes,
            num_anchors=num_anchors,
            activation=cfg.activation,
            dropout_rate=cfg.dropout_rate,
            fpn_channels=cfg.fpn_channels,
            head_depth=cfg.head_depth,
            prior_prob=cfg.prior_prob,
            quantize=cfg.quantize == "int8",
            fused_blocks=cfg.fused_blocks,
            fused_res2=cfg.fused_res2,
            fused_res2_strips=cfg.fused_res2_strips,
            fused_res3_strips=cfg.fused_res3_strips,
            fused_res4_strips=cfg.fused_res4_strips,
            fused_proj=cfg.fused_proj,
            fused_train=cfg.fused_train,
            remat=cfg.remat,
            dtype=getattr(torch, cfg.compute_dtype))

    def forward(self, images: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Dict[str, Tensor]]:
        """``training`` turns the backbone's dropout on (masks from
        ``generator``: one seed drawn per call, ``DropoutKeys``), routes
        the dense model's identity blocks through B3 under
        ``fused_train``, and returns float32 head outputs.  A backbone with
        dropout needs ``generator`` to train; the FPN and heads have none."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        keys = (DropoutKeys.draw(generator)
                if training and generator is not None and self.dropout_sites
                else None)
        bottom_up = self.backbone_net(x, training, keys)
        top_down = self.fpn({k: bottom_up[k] for k in ("C3", "C4", "C5")})
        return {
            "classifications": {k: self.classification_subnet(v, training)
                                for k, v in top_down.items()},
            "regressions": {k: self.regression_subnet(v, training)
                            for k, v in top_down.items()},
        }


def l2_scale(name: str, backbone: str, scale: float = 1e-4) -> float:
    """The L2 weight of the parameter ``name``: 0 but for conv ``kernel``s
    (GroupNorm γ/β and biases are not regularized); kernels under
    ``backbone_net`` take 4e-5 for ``mobilenet_v2``, ``scale`` otherwise."""
    if name.rsplit(".", 1)[-1] != "kernel":
        return 0.0
    if name.startswith("backbone_net.") and backbone == "mobilenet_v2":
        return 4e-5
    return scale


def l2_regularization(named_params: Iterable[Tuple[str, Tensor]],
                      backbone: str, scale: float = 1e-4) -> Tensor:
    """TF-parity L2 loss: ``l2_scale · Σw² / 2`` summed over every conv
    ``kernel``; its gradient is ``l2_scale · w``."""
    return sum(l2_scale(name, backbone, scale)
               * torch.sum(torch.square(value.float())) / 2
               for name, value in named_params
               if name.rsplit(".", 1)[-1] == "kernel")
