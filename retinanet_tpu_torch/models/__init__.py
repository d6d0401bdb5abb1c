"""PyTorch models: layers, dense ResNet-50, FPN, heads, RetinaNet."""

from retinanet_tpu_torch.models.retinanet import (  # noqa: F401
    RetinaNet, build_backbone)
