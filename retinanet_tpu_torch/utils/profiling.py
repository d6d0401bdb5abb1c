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
    ("B2 nms.cu", ("b2_nms",)),
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
# The kernel of ``torch.cuda._sleep``, which ``kernel_sequence`` launches
# MARKERS times before and after the profiled calls, a host pause of
# SETTLE_S between each group of markers and the calls.  A profile may miss
# the kernels launched in its first moments (more often after many earlier
# profiles in one process; what it missed was every opening marker and none
# of the calls' kernels), so each profile starts with a host pause of
# SETTLE_S.  A window counts only where it kept every closing marker and at
# least one opening one, and is taken again up to ATTEMPTS times.
MARKER, MARKERS, SETTLE_S, ATTEMPTS = "spin_kernel", 16, 0.05, 3
# Windows that lost kernels and were taken again, over the process.
lossy_windows = 0


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


def _markers() -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _intact(events) -> bool:
    """Whether a window's kernels (sorted by start) hold at least one
    opening marker and all MARKERS closing ones: the opening and closing
    groups are split by the one gap between markers of at least SETTLE_S."""
    starts = [e.time_range.start for e in events if MARKER in e.name]
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    if not gaps:
        return False
    split = max(range(len(gaps)), key=gaps.__getitem__)
    return (gaps[split] >= SETTLE_S * 1e6
            and len(starts) - split - 1 == MARKERS)


def kernel_sequence(call: Callable[[], None], calls: int = 1
                    ) -> List[Tuple[str, float]]:
    """(kernel name, device ms) of every kernel that ``calls``
    synchronised calls of ``call`` launch, after a warm one, in the order
    they start, from a window that lost none of them (``_intact``; raises
    after ATTEMPTS lossy windows)."""
    global lossy_windows
    call()
    torch.cuda.synchronize()
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(SETTLE_S)
            _markers()
            time.sleep(SETTLE_S)
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            _markers()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if _intact(events):
            return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                    for e in events if MARKER not in e.name]
        lossy_windows += 1
    raise RuntimeError(f"{ATTEMPTS} profile windows in a row lost kernels")


def kernel_launches(call: Callable[[], None], calls: int = CALLS
                    ) -> Dict[str, Tuple[float, float]]:
    """{kernel name: (launches, device ms)} per call, over ``calls``
    synchronised calls of ``call`` after a warm one."""
    by_name: Dict[str, Tuple[float, float]] = {}
    for name, ms in kernel_sequence(call, calls):
        n, total = by_name.get(name, (0.0, 0.0))
        by_name[name] = (n + 1.0 / calls, total + ms / calls)
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
        time.sleep(SETTLE_S)
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
