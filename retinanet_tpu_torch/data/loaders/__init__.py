"""Dataset loaders: COCO, Pascal VOC, synthetic Shapes, dispatcher."""

from retinanet_tpu_torch.data.loaders.base import Base  # noqa: F401
from retinanet_tpu_torch.data.loaders.inferred import Inferred  # noqa: F401
