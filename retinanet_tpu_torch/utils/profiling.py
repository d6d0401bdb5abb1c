"""Where the device time goes: a ``torch.profiler`` breakdown of one
call on the card (``device_breakdown``), by kernel group.

``chip_smoke.py`` runs it on the flagship's serving batch (kernel, int8
and plain paths) and training step (kernel and plain paths).  Needs a
CUDA device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

# Kernel groups, first match wins: (group, substrings of the kernel name).
GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("B3 bottleneck_bwd.cu", ("b3_fused_bottleneck_bwd",)),
    ("B1 bottleneck.cu", ("b1_fused_bottleneck",)),
    ("B2 nms.cu", ("nms_mask", "nms_scan")),
    ("B4 groupnorm.cu", ("b4_group_norm",)),
    ("B5 bottleneck_proj.cu", ("b5_fused_bottleneck_proj",)),
    ("B6 int8_conv.cu", ("b6_int8_conv",)),
    ("B7 stem.cu", ("b7_gn_relu_maxpool",)),
    ("convolution (cuDNN)", ("cudnn", "xmma", "conv", "dgrad", "wgrad",
                             "implicit_gemm", "fprop", "nhwc", "nchw")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_", "ampere")),
    ("reduction", ("reduce_kernel", "reduce")),
    ("sort / scan / index", ("sort", "radix", "scan", "index", "gather",
                             "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / memset", ("memcpy", "memset", "copy")),
)


TOP_KERNELS = 8  # kernels listed by name, the longest first
CALLS = 3  # profiled calls, after one warm call
# The kernel of ``torch.cuda._sleep``, which ``kernel_launches`` launches
# first in its window (the profile may miss a window's first kernel) and
# does not count.
MARKER = "spin_kernel"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def kernel_launches(call: Callable[[], None], calls: int = CALLS
                    ) -> Dict[str, Tuple[float, float]]:
    """{kernel name: (launches, device ms)} per call, over ``calls``
    synchronised calls of ``call`` after a warm one."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    by_name: Dict[str, Tuple[float, float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and MARKER not in e.name:
            n, ms = by_name.get(e.name, (0.0, 0.0))
            by_name[e.name] = (n + 1.0 / calls, ms + (
                e.time_range.end - e.time_range.start) / 1e3 / calls)
    return by_name


def device_breakdown(call: Callable[[], None]) -> Dict[str, object]:
    """Profile ``CALLS`` synchronised calls of ``call`` after a warm one:
    wall ms per call (host clock), device busy ms per call (the union of
    kernel spans), the idle share, kernels per call, peak memory, device
    ms per kernel group and the longest kernels by name."""
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / CALLS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_group: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = _union_us(spans) / 1e3 / CALLS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        "kernels_per_call": len(kernels) / CALLS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "device_ms": {g: v / 1e3 / CALLS for g, v in
                      sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [[name[:120], v / 1e3 / CALLS] for name, v in top],
    }
