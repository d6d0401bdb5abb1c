"""retinanet_tpu_torch — the PyTorch/CUDA port of ``retinanet_tpu``.

The JAX package stays the reference; this package computes the same
functions in PyTorch for an NVIDIA H100, module by module under the same
names (``ops.boxes``, ``models.resnet``, ``infer`` ...).  Public functions
keep the JAX layout (NHWC images, ``[B,H,W,A,K]`` head maps,
``BoxesDecoded`` detections); inside, activations are NCHW tensors in
``channels_last`` memory so cuDNN convolutions and the hand-written kernels
both read NHWC bytes.

The port imports nothing of the JAX package, nor ``jax``/``flax``: it keeps
its own copies of what it needs (``config`` for ``Config``,
``ops.anchors`` for the anchor pyramid, ``data`` and the evaluators, the
C++ host runtime under ``host``), held equal to the originals by the CPU
tests.  The kernels that replace the Pallas ones live under ``ops/csrc``
and build with ``nvcc`` at first use.

Slices ported: serving (``infer``), the training step (``train``) and
the evaluation path (``data``, ``eval_coco``, ``eval_voc``, ``export``,
the ``evaluate`` and ``detect`` CLIs).
"""

__version__ = "0.1.0"

from retinanet_tpu_torch.config import Config  # noqa: F401
