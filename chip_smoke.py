#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``retinanet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card of capability 9.0 (H100); exits non-zero without one.
Phases, one line each (any failure raises and the exit code is non-zero):

1. device: torch version, ``nvidia-smi`` name and power limit, capability;
2. build: both hand-written kernels with ``nvcc``; ptxas register/smem/
   spill lines;
3. B1 check: fused bottleneck kernel vs its plain version at the four
   stage shapes of the 640-px flagship (batch 2 and 8, randomized GN
   γ/β), and bitwise repeatability;
4. B2 check: NMS keep-mask kernel vs the plain greedy mask on clustered,
   class-offset boxes with parked invalids: exactly equal;
5. flagship end to end: resnet_50_dense RetinaNet at 640 px, 80 classes,
   bf16, seeded random weights, through ``Detector`` at batch 8, at the
   default NMSConfig and at score_threshold 0.005; launch counts, head
   outputs vs the unfused plain path, B2 on the model's own candidates;
6. timing: images/s and p50 at batch 8 and 128, and each kernel vs its
   plain version at the slice's shapes (CUDA events after warmup).

Then a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from retinanet_tpu.config import Config
from retinanet_tpu.ops.anchors import build_levels
from retinanet_tpu_torch.export import init_params
from retinanet_tpu_torch.infer import Detector, benchmark
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops import bottleneck as b1
from retinanet_tpu_torch.ops import nms as b2

# (H, W, C, F) of the 12 identity blocks at 640 px, with their counts.
STAGES = (("res2", 160, 160, 256, 64, 2), ("res3", 80, 80, 512, 128, 3),
          ("res4", 40, 40, 1024, 256, 5), ("res5", 20, 20, 2048, 512, 2))
# B1 bound: |Δ| ≤ 2⁻⁵·max(1, |ref|) per element and mean |Δ| ≤ 1e-3.  Both
# versions round every conv to bf16 but sum it in another fp32 order, so
# elements may sit one bf16 step apart and GN carries the step through.
B1_REL = 2.0 ** -5
B1_MEAN = 1e-3
# Head outputs of the kernel path vs the unfused plain path: the JAX
# package's own fused-vs-unfused backbone bound (test_pallas_bottleneck).
HEAD_RTOL, HEAD_ATOL = 5e-2, 1e-1


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(batch, h, w, c, f, gen, device):
    """Random bf16 block input and He-normal kernels, randomized GN γ/β."""
    def he(*shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in)
    x = torch.randn(batch, h, w, c, generator=gen).to(torch.bfloat16)
    params = []
    for shape in ((f, c, 1, 1), (f, f, 3, 3), (c, f, 1, 1)):
        n = shape[0]
        params += [he(*shape), 1.0 + 0.3 * torch.randn(n, generator=gen),
                   0.3 * torch.randn(n, generator=gen)]
    return x.to(device), [p.to(device) for p in params]


def check_b1(device) -> float:
    """B1 vs plain at every stage shape, at batch 2 and at the flagship
    run's batch 8."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for batch in (2, 8):
        for name, h, w, c, f, _ in STAGES:
            x, params = block_inputs(batch, h, w, c, f, gen, device)
            ref = b1.fused_bottleneck_plain(x, *params).float()
            out = b1.fused_bottleneck(x, *params)
            again = b1.fused_bottleneck(x, *params)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            bound = B1_REL * ref.abs().clamp(min=1.0)
            log("b1-check", stage=name, shape=[batch, h, w, c], F=f,
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                over_bound=int((err > bound).sum().item()),
                bitwise_repeat=bool(torch.equal(out, again)))
            if (err > bound).any() or err.mean().item() > B1_MEAN:
                raise AssertionError(f"B1 disagrees with its plain version "
                                     f"at {name}, batch {batch}")
            if not torch.equal(out, again):
                raise AssertionError(f"B1 is not bitwise repeatable at "
                                     f"{name}, batch {batch}")
            worst = max(worst, err.max().item())
    return worst


def clustered_boxes(batch, n, gen, quantized=False):
    """Score-sorted candidates as the serving path builds them: clustered
    corner boxes, class offsets ``ids·4``, 20% invalid parked −1e4."""
    centers = torch.rand(batch, n, 2, generator=gen) * 0.8 + 0.1
    sizes = torch.rand(batch, n, 2, generator=gen) * 0.25 + 0.05
    if quantized:  # a coarse grid gives exact IoU ties, at 0.5 too
        centers = (centers * 32).round() / 32
        sizes = (sizes * 16).round().clamp(min=1) / 16
    boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
    ids = torch.randint(0, 4, (batch, n), generator=gen)
    boxes = boxes + (ids[..., None] * 4.0)
    valid = torch.rand(batch, n, generator=gen) > 0.2
    return torch.where(valid[..., None], boxes, boxes - 1e4).float()


def check_b2(device) -> int:
    gen = torch.Generator().manual_seed(2)
    mismatches = 0
    for shape, quantized in (((8, 1000), False), ((3, 200), False),
                             ((8, 1000), True)):
        boxes = clustered_boxes(*shape, gen, quantized).to(device)
        want = b2._greedy_keep_mask(boxes, 0.5)
        got = b2.nms_keep_mask_batch(boxes, 0.5)
        diff = int((got != want).sum().item())
        log("b2-check", shape=[*shape, 4], quantized=quantized,
            kept=int(want.sum().item()), mismatches=diff)
        if diff:
            raise AssertionError(f"B2 keep mask differs at {shape}")
        mismatches += diff
    return mismatches


def flagship_config(batch: int = 8) -> Config:
    """The JAX bench's serving config (bench.py:94-119) at 80 classes."""
    config = Config()
    return config.replace(
        model=dataclasses.replace(
            config.model, backbone="resnet_50_dense", fused_blocks=True,
            fused_res2=True, fused_res3_strips=10, fused_res4_strips=10),
        data=dataclasses.replace(config.data, image_size=640,
                                 batch_size=batch),
        nms=dataclasses.replace(config.nms, use_approx_top_k=True))


def check_flagship(device):
    config = flagship_config()
    low = config.replace(nms=dataclasses.replace(config.nms,
                                                 score_threshold=0.005))
    names = [str(i) for i in range(80)]
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    detectors = [Detector(c, state, names, device) for c in (config, low)]
    images = torch.randn(8, 640, 640, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)

    # The main path, counted: both NMS configs, one batch each.
    b1.fused_bottleneck.launches = 0
    b2.nms_keep_mask_batch.launches = 0
    outs = [det(images) for det in detectors]
    torch.cuda.synchronize()
    launches = {"b1": b1.fused_bottleneck.launches,
                "b2": b2.nms_keep_mask_batch.launches}
    log("flagship-launches", **launches, batches=2)
    if launches["b1"] != 24 or launches["b2"] < 2:
        raise AssertionError(f"expected 12 B1 launches per forward and a B2 "
                             f"launch per batch, got {launches}")

    for label, out in zip(("default", "score_threshold=0.005"), outs):
        finite = all(bool(torch.isfinite(t.float()).all()) for t in
                     (out.boxes, out.scores))
        log("flagship-output", nms=label, boxes=list(out.boxes.shape),
            valid=int(out.valid.sum().item()), finite=finite)
        if not finite or tuple(out.boxes.shape) != (8, 1000, 4):
            raise AssertionError(f"bad detections at {label}")
    if int(outs[1].valid.sum().item()) == 0:
        raise AssertionError("no detections at score_threshold 0.005")

    # Kernel path vs the unfused plain path on the same weights and images.
    fused = detectors[0].model
    plain = RetinaNet.from_config(dataclasses.replace(
        config.model, fused_blocks=False, fused_res2=False), 9, 80)
    plain.load_state_dict(state)
    plain.to(device).eval()
    with torch.inference_mode():
        got, want = fused(images), plain(images)
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            g, w = got[head][pn].float(), want[head][pn].float()
            err = (g - w).abs()
            corr = torch.corrcoef(torch.stack([g.ravel(), w.ravel()]))[0, 1]
            ok = bool((err <= HEAD_ATOL + HEAD_RTOL * w.abs()).all())
            log("flagship-heads", head=head, level=pn,
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                ref_std=w.std().item(), corr=corr.item(), within_bound=ok)
            if not ok:
                raise AssertionError(f"kernel path disagrees at {head}/{pn}")

    # B2 on the model's own candidates equals the plain mask.
    levels = build_levels(config.anchors)
    for c in (config.nms, low.nms):
        with torch.inference_mode():
            cand, shifted = b2.nms_candidates(
                got["classifications"], got["regressions"], levels,
                (640, 640), c)
            diff = int((b2.nms_keep_mask_batch(shifted, c.iou_threshold)
                        != b2._greedy_keep_mask(shifted, c.iou_threshold)
                        ).sum().item())
        log("flagship-b2", score_threshold=c.score_threshold,
            valid_candidates=int(cand.valid.sum().item()), mismatches=diff)
        if diff:
            raise AssertionError("B2 differs on the model's candidates")
    del detectors, plain, fused
    torch.cuda.empty_cache()
    return launches


def time_kernels(device):
    gen = torch.Generator().manual_seed(4)
    b1_ms = b1_plain_ms = 0.0
    for name, h, w, c, f, count in STAGES:
        x, params = block_inputs(8, h, w, c, f, gen, device)
        k_ms = cuda_time_ms(lambda: b1.fused_bottleneck(x, *params), 10)
        p_ms = cuda_time_ms(lambda: b1.fused_bottleneck_plain(x, *params), 10)
        log("b1-time", stage=name, batch=8, kernel_ms=k_ms, plain_ms=p_ms,
            blocks_per_forward=count)
        b1_ms += count * k_ms
        b1_plain_ms += count * p_ms
    boxes = clustered_boxes(8, 1000, gen).to(device)
    b2_ms = cuda_time_ms(lambda: b2.nms_keep_mask_batch(boxes, 0.5), 20)
    b2_plain_ms = cuda_time_ms(lambda: b2._greedy_keep_mask(boxes, 0.5), 3,
                               warmup=1)
    log("b2-time", shape=[8, 1000, 4], kernel_ms=b2_ms, plain_ms=b2_plain_ms)
    return (b1_ms, b1_plain_ms), (b2_ms, b2_plain_ms)


def time_end_to_end(device):
    for batch in (8, 128):
        for path in ("kernels", "plain"):
            config = flagship_config(batch)
            if path == "plain":
                config = config.replace(model=dataclasses.replace(
                    config.model, fused_blocks=False, fused_res2=False))
            r = benchmark(config, batch_size=batch,
                          steps=10 if batch == 8 else 5, warmup=2,
                          num_classes=80, device=device)
            log("e2e-time", path=path, batch=batch,
                images_per_sec=r["images_per_sec"],
                p50_ms=r["p50_latency_ms"], p99_ms=r["p99_latency_ms"])
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs capability (9, 0), got {cap}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    smi = nvidia_smi()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=smi, capability=list(cap))

    for lib in (b1.LIB, b2.LIB):
        t = time.monotonic()
        lib.build()
        lines = [ln.strip() for ln in lib.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        log("build", source=lib.source.name, seconds=time.monotonic() - t,
            ptxas=lines)

    b1_err = check_b1(device)
    b2_err = check_b2(device)
    launches = check_flagship(device)
    (b1_ms, b1_plain), (b2_ms, b2_plain) = time_kernels(device)
    time_end_to_end(device)

    print(json.dumps({"kernels": [
        {"name": "fused_bottleneck", "route": "cuda",
         "source": "retinanet_tpu_torch/ops/csrc/bottleneck.cu",
         "replaces": "retinanet_tpu/ops/pallas/bottleneck.py:372",
         "launches": launches["b1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain},
        {"name": "nms_keep_mask_batch", "route": "cuda",
         "source": "retinanet_tpu_torch/ops/csrc/nms.cu",
         "replaces": "retinanet_tpu/ops/pallas/nms_kernel.py:162",
         "launches": launches["b2"], "max_abs_err": float(b2_err),
         "ms": b2_ms, "plain_ms": b2_plain},
    ]}), flush=True)
    log("done", seconds=time.monotonic() - t0)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
