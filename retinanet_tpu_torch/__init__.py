"""retinanet_tpu_torch — the PyTorch/CUDA port of ``retinanet_tpu``.

The JAX package stays the reference; this package computes the same
functions in PyTorch for an NVIDIA H100, module by module under the same
names (``ops.boxes``, ``models.resnet``, ``infer`` ...).  Public functions
keep the JAX layout (NHWC images, ``[B,H,W,A,K]`` head maps,
``BoxesDecoded`` detections); inside, activations are NCHW tensors in
``channels_last`` memory so cuDNN convolutions and the hand-written kernels
both read NHWC bytes.

Shared with the JAX package (both import no JAX): ``retinanet_tpu.config``
for the one ``Config`` and ``retinanet_tpu.ops.anchors`` for the anchor
pyramid.  Nothing here imports ``jax``; the kernels that replace the
Pallas ones live under ``ops/csrc`` and build with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

from retinanet_tpu.config import Config  # noqa: F401
