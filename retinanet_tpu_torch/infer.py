"""Inference path (port of ``retinanet_tpu/infer.py``).

``make_inference_fn`` builds images → normalize → forward (compute dtype)
→ ``fused_decode_nms``, on one device or data-parallel over several (the
JAX package's ``mesh=`` serving); ``Detector`` wraps it with weights,
explicit devices and host-side numpy detections; ``benchmark`` times it on
the card; ``forward_gflops_per_image`` counts the model's forward FLOPs,
the numerator of a serving MFU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor
from torch.utils.flop_counter import FlopCounterMode

from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.ops.anchors import Levels, build_levels
from retinanet_tpu_torch.export import init_params, load_exported
from retinanet_tpu_torch.models.layers import (force_true_grouped,
                                               use_group_norm_kernel)
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops.nms import BoxesDecoded, fused_decode_nms
from retinanet_tpu_torch.ops.preprocess import maybe_normalize

logger = logging.getLogger(__name__)

Device = Union[str, torch.device]


def make_inference_fn(model: RetinaNet, levels: Levels, config: Config,
                      devices: Optional[Sequence[Device]] = None
                      ) -> Callable[[Tensor], BoxesDecoded]:
    """images [B,H,W,3] (float normalized, or uint8) → BoxesDecoded, with no
    host synchronisation inside.

    One device (``devices`` None or one long): the images on the model's
    device, the detections there.  Several (data-parallel serving, the
    JAX package's ``mesh=``): the model on ``devices[0]`` and a copy of it
    on each other device, made now; the batch (best left on the host)
    splits into equal contiguous chunks, chunk i goes straight to device
    i and runs there, and the detections come back to ``devices[0]`` in
    batch order.  Decode and NMS are per image, so no device waits for
    another.  The batch must divide by the device count."""
    nms_cfg = config.nms
    if nms_cfg.use_approx_top_k or nms_cfg.use_approx_global_top_k:
        logger.info("use_approx_top_k names a TPU unit; the port selects "
                    "candidates with exact top-k")

    @torch.inference_mode()
    def infer_on(replica: RetinaNet, images: Tensor) -> BoxesDecoded:
        images = maybe_normalize(images, config.data)
        out = replica(images)
        return fused_decode_nms(out["classifications"], out["regressions"],
                                levels, tuple(images.shape[1:3]), nms_cfg)

    if devices is None or len(devices) <= 1:
        return lambda images: infer_on(model, images)
    devices = [torch.device(d) for d in devices]
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]
    cuda = any(d.type == "cuda" for d in devices)

    @torch.inference_mode()
    def infer(images: Tensor) -> BoxesDecoded:
        if images.shape[0] % len(devices):
            raise ValueError(f"data-parallel serving needs a batch divisible "
                             f"by the {len(devices)} devices, got "
                             f"{images.shape[0]}")
        if images.device.type == "cpu" and cuda:
            images = images.pin_memory()  # each chunk copies asynchronously
        outs = [infer_on(replica, chunk.to(device, non_blocking=True))
                for replica, chunk, device in
                zip(replicas, images.chunk(len(devices)), devices)]
        return BoxesDecoded(*(torch.cat([o[i].to(devices[0]) for o in outs])
                              for i in range(len(BoxesDecoded._fields))))

    return infer


class Detector:
    """User-facing inference wrapper on one device, the card unless the
    caller passes another, or data-parallel over ``devices``
    (``make_inference_fn``; ``config.data.batch_size`` must divide by
    their count).  ``model`` is the replica on the first device."""

    def __init__(self, config: Config, state_dict: Mapping[str, Tensor],
                 class_names: List[str], device: Device = "cuda",
                 devices: Optional[Sequence[Device]] = None):
        self.config = config
        self.class_names = class_names
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if config.data.batch_size % len(self.devices):
            raise ValueError(
                f"data-parallel serving needs batch_size divisible by the "
                f"device count ({config.data.batch_size} % "
                f"{len(self.devices)} != 0)")
        self.levels = build_levels(config.anchors)
        self.model = RetinaNet.from_config(
            config.model, num_anchors=self.levels.num_anchors,
            num_classes=len(class_names))
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self._fn = make_inference_fn(self.model, self.levels, config,
                                     self.devices)

    @classmethod
    def from_export(cls, path: str, config: Optional[Config] = None,
                    device: Device = "cuda",
                    devices: Optional[Sequence[Device]] = None
                    ) -> "Detector":
        """Serve a JAX export file; backbone and classes come from it."""
        meta, state_dict, class_names, image_size = load_exported(path)
        if config is None:
            config = Config()
            config = config.replace(data=dataclasses.replace(
                config.data, image_size=image_size))
        config = config.replace(model=dataclasses.replace(
            config.model, backbone=meta["backbone"],
            num_classes=len(class_names)))
        return cls(config, state_dict, class_names, device, devices)

    def __call__(self, images: Union[np.ndarray, Tensor]) -> BoxesDecoded:
        """images: [B, H, W, 3] normalized float32 (or uint8) →
        BoxesDecoded on the detector's (first) device.  Over several
        devices each chunk of the batch goes from where it lies straight
        to its own device."""
        images = torch.as_tensor(images)
        if len(self.devices) == 1:
            images = images.to(self.device)
        return self._fn(images)

    def detect(self, images: Union[np.ndarray, Tensor],
               scales: Optional[np.ndarray] = None) -> List[Dict]:
        """Per-image numpy detections (t,l,b,r pixels of the canvas, or of
        the original image when ``scales`` maps canvas → original)."""
        out = BoxesDecoded(*(t.cpu().numpy() for t in self(images)))
        canvas_h, canvas_w = images.shape[1], images.shape[2]
        scale_tlbr = np.array([canvas_h, canvas_w, canvas_h, canvas_w],
                              np.float32)
        results = []
        for i in range(out.boxes.shape[0]):
            valid = out.valid[i]
            boxes = out.boxes[i][valid] * scale_tlbr
            if scales is not None:
                boxes = boxes / scales[i]
            results.append({"boxes": boxes,
                            "scores": out.scores[i][valid],
                            "class_ids": out.class_ids[i][valid]})
        return results


def benchmark(config: Config, batch_size: int = 8, steps: int = 20,
              warmup: int = 3, num_classes: int = 80,
              device: Union[str, torch.device] = "cuda",
              group_norm_kernel: bool = False) -> Dict[str, float]:
    """images/sec + p50/p99 latency of the full inference path on random
    images and seeded random weights; ``group_norm_kernel`` routes every
    GroupNorm through kernel B4 (``use_group_norm_kernel``).  Needs a CUDA
    device: a time taken on the CPU is not the card's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark times the card; got device {device}")
    gen = torch.Generator().manual_seed(0)
    detector = Detector(config, init_params(config, gen, num_classes),
                        [str(i) for i in range(num_classes)], device)
    use_group_norm_kernel(detector.model, group_norm_kernel)
    size = config.data.image_size
    images = torch.randn(batch_size, size, size, 3, generator=gen).to(device)

    def sync(out: BoxesDecoded) -> None:
        out.scores.sum().item()

    for _ in range(warmup):
        sync(detector(images))

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = None
    for _ in range(steps):
        out = detector(images)
    sync(out)
    total = time.perf_counter() - t0

    lat = []
    for _ in range(min(steps, 10)):
        t1 = time.perf_counter()
        sync(detector(images))
        lat.append(time.perf_counter() - t1)
    lat = np.asarray(lat)
    return {
        "images_per_sec": batch_size * steps / total,
        "p50_latency_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_latency_ms": float(np.percentile(lat, 99)) * 1e3,
        "batch_size": batch_size,
        "image_size": size,
    }


def forward_gflops_per_image(config: Config, num_classes: int = 80,
                             algorithmic: bool = False) -> float:
    """Forward GFLOPs per image of the model at ``config.data.image_size``.

    Counted by ``FlopCounterMode`` (convolutions and matrix products, 2
    per multiply-add, a conv by its weight's shape) on the unfused float
    model (``fused_*`` off, ``quantize="none"``: the kernels compute the
    same convolutions) built on the meta device: no device work, no
    compile.  By default a grouped conv that runs block-diagonal dense
    (``Conv.grouped_as_dense``) counts its dense MACs, as it runs;
    ``algorithmic`` counts it truly grouped (``force_true_grouped``), the
    JAX package's two modes.
    """
    model_cfg = dataclasses.replace(
        config.model, fused_blocks=False, fused_res2=False,
        fused_res3_strips=0, fused_res4_strips=0, fused_proj=False,
        fused_train=False, quantize="none")
    size = config.data.image_size
    with torch.device("meta"):
        model = RetinaNet.from_config(model_cfg,
                                      build_levels(config.anchors).num_anchors,
                                      num_classes).eval()
        images = torch.empty(1, size, size, 3)
    counter = FlopCounterMode(display=False)
    grouped = (force_true_grouped() if algorithmic
               else contextlib.nullcontext())
    with counter, grouped, torch.no_grad():
        model(images)
    return counter.get_total_flops() / 1e9
