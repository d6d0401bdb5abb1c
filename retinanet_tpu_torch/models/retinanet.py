"""RetinaNet assembly (port of ``retinanet_tpu/models/retinanet.py``).

backbone → FPN → shared classification/regression subnets on P3..P7.
Images come in NHWC (the JAX layout) and are viewed as NCHW in
``channels_last`` memory; outputs are ``{'classifications': {P3..P7:
[B,H,W,A,K]}, 'regressions': {P3..P7: [B,H,W,A,4]}}`` in the compute
dtype (float32 logits when training).  ``l2_regularization`` is the
TF-parity L2 loss over the conv kernels.  Only the dense ResNet-50 flagship
is built so far; ``quantize="int8"`` serves it with int8 backbone and FPN
convs (heads and stem float) on the float model's parameters.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import Tensor, nn

from retinanet_tpu_torch.config import ModelConfig
from retinanet_tpu_torch.models.fpn import FPN
from retinanet_tpu_torch.models.heads import (ClassificationSubnet,
                                              RegressionSubnet)
from retinanet_tpu_torch.models.resnet import ResNet50

BACKBONES = ("resnet_50", "resnet_50_dense", "densenet_121", "densenet_169",
             "mobilenet_v2")


def build_backbone(name: str, quantize: bool = False,
                   fused_blocks: bool = False, fused_res2: bool = False,
                   fused_res2_strips: int = 20, fused_res3_strips: int = 0,
                   fused_res4_strips: int = 0, fused_proj: bool = False,
                   fused_train: bool = False, remat: bool = False
                   ) -> nn.Module:
    if name == "resnet_50_dense":
        return ResNet50(fused_blocks=fused_blocks, fused_res2=fused_res2,
                        fused_res2_strips=fused_res2_strips,
                        fused_res3_strips=fused_res3_strips,
                        fused_res4_strips=fused_res4_strips,
                        fused_train=fused_train, fused_proj=fused_proj,
                        quantize=quantize, remat=remat)
    if name in BACKBONES:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ROADMAP A.6, other "
            "backbones); only 'resnet_50_dense' is")
    raise ValueError(f"unknown backbone {name!r}; choose from {BACKBONES}")


class RetinaNet(nn.Module):
    """Full detector.  Construct via ``RetinaNet.from_config(cfg.model)``."""

    def __init__(self, backbone: str = "resnet_50_dense",
                 num_classes: int = 80, num_anchors: int = 9,
                 activation: str = "elu", fpn_channels: int = 256,
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
            fused_train=fused_train, remat=remat)
        self.fpn = FPN({"C3": 512, "C4": 1024, "C5": 2048}, fpn_channels,
                       activation, quantize)
        # The heads stay float under int8 serving (retinanet.py:150-165).
        self.classification_subnet = ClassificationSubnet(
            num_anchors, num_classes, fpn_channels, head_depth, activation,
            prior_prob)
        self.regression_subnet = RegressionSubnet(
            num_anchors, fpn_channels, head_depth, activation)

    @classmethod
    def from_config(cls, cfg: ModelConfig, num_anchors: int = 9,
                    num_classes: int = None) -> "RetinaNet":
        return cls(
            backbone=cfg.backbone,
            num_classes=cfg.num_classes if num_classes is None
            else num_classes,
            num_anchors=num_anchors,
            activation=cfg.activation,
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

    def forward(self, images: Tensor, training: bool = False
                ) -> Dict[str, Dict[str, Tensor]]:
        """``training`` routes the identity blocks through B3 under
        ``fused_train`` and returns float32 head outputs; the FPN has no
        layer that depends on it (this model has no dropout)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        bottom_up = self.backbone_net(x, training)
        top_down = self.fpn({k: bottom_up[k] for k in ("C3", "C4", "C5")})
        return {
            "classifications": {k: self.classification_subnet(v, training)
                                for k, v in top_down.items()},
            "regressions": {k: self.regression_subnet(v, training)
                            for k, v in top_down.items()},
        }


def l2_regularization(named_params: Iterable[Tuple[str, Tensor]],
                      backbone: str, scale: float = 1e-4) -> Tensor:
    """TF-parity L2 loss: ``scale · Σw² / 2`` over every conv ``kernel``
    (GroupNorm γ/β and biases are not regularized); kernels under
    ``backbone_net`` take 4e-5 for ``mobilenet_v2``, ``scale`` otherwise."""
    backbone_scale = 4e-5 if backbone == "mobilenet_v2" else scale
    return sum((backbone_scale if name.startswith("backbone_net.") else scale)
               * torch.sum(torch.square(value.float())) / 2
               for name, value in named_params
               if name.rsplit(".", 1)[-1] == "kernel")
