"""Host-side data pipeline and dataset loaders (the port's own copies of
``retinanet_tpu/data``, numpy only)."""

from retinanet_tpu_torch.data.pipeline import Batch, build_pipeline  # noqa: F401
