"""Tensor ops of the port: boxes, preprocessing, decode + NMS, and the
wrappers of the hand-written CUDA kernels (``bottleneck``, ``nms``)."""
