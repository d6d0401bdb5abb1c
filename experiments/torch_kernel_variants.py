#!/usr/bin/env python3
"""Design variants of two port kernels, timed in turns on one H100: the
measurements behind two fixed choices of ``retinanet_tpu_torch``.

    python3 experiments/torch_kernel_variants.py

- B2 (``ops/csrc/nms.cu``) at [8,1000,4] and [128,1000,4]: the scan's
  narrow instance (``nms_scan<false>``, up to 2048 boxes) against the wide
  instance forced at every N, and warp 1's unconditional, masked row loads
  against loads under the kept bit (narrow and wide).
- B7 (``ops/csrc/stem.cu``) at [8|128,320,320,64]: output rows per CTA
  (``ROWS``) 2, 8, 16 and 32 against the source's 4.

Each variant is the source with one line rewritten, built into
``build/variants/`` beside the headers it includes, and must give the
source's output bitwise.  Prints the card's name and power limit, then one
JSON line per shape: the device ms (queued behind a sleep kernel) of each
variant, taken in turns (in order, then reversed, three times), and their
medians.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from retinanet_tpu_torch.ops import nms as b2  # noqa: E402
from retinanet_tpu_torch.ops import stem as b7  # noqa: E402
from retinanet_tpu_torch.ops.cuda import CSRC, local_headers  # noqa: E402

VARIANTS = ROOT / "build" / "variants"
OPS = ROOT / "retinanet_tpu_torch" / "ops"

WIDE = ("  const bool wide = NW > 32;", "  const bool wide = true;")
KEPT_BIT_LOADS = ("    acc |= col[rr] & (0ull - ((kept >> rr) & 1ull));",
                  "    acc |= ((kept >> rr) & 1ull) ? col[rr] : 0ull;")
B2_VARIANTS = {"wide": [WIDE], "kept_bit_loads": [KEPT_BIT_LOADS],
               "wide_kept_bit_loads": [WIDE, KEPT_BIT_LOADS]}
B7_VARIANTS = {f"rows_{r}": [("constexpr int ROWS = 4;",
                              f"constexpr int ROWS = {r};")]
               for r in (2, 8, 16, 32)}


def variant(module: str, name: str, edits):
    """A fresh copy of ``ops/<module>.py`` whose kernel library builds
    ``csrc/<module>.cu`` with each (old, new) line of ``edits`` replaced."""
    source = CSRC / f"{module}.cu"
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{source.name}: {old.strip()!r} is not one "
                             f"line of the source")
        text = text.replace(old, new)
    folder = VARIANTS / f"{module}-{name}"
    folder.mkdir(parents=True, exist_ok=True)
    for header in local_headers(source):
        shutil.copy(header, folder / header.name)
    (folder / source.name).write_text(text)
    spec = importlib.util.spec_from_file_location(f"{module}_{name}",
                                                  OPS / f"{module}.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    copy.LIB.source = folder / source.name
    return copy


def in_turns(calls, iters: int, rounds: int = 3):
    order = list(calls)
    ms = {who: [] for who in order}
    for _ in range(rounds):
        for who in order + order[::-1]:
            ms[who].append(cs.cuda_time_ms(calls[who], iters, queued=True))
    return ms


def report(kernel: str, shape, same, ms) -> None:
    print(json.dumps({"kernel": kernel, "shape": list(shape),
                      "bitwise_equal_to_source": same,
                      "median_device_ms": {k: statistics.median(v)
                                           for k, v in ms.items()},
                      "device_ms_in_turns": ms}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    nms = {"source": b2, **{k: variant("nms", k, e)
                            for k, e in B2_VARIANTS.items()}}
    stem = {"source": b7, **{k: variant("stem", k, e)
                             for k, e in B7_VARIANTS.items()}}
    modules = [*nms.values(), *stem.values()]
    with ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda m: m.LIB.build(), modules))
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator().manual_seed(12)
    for shape in ((8, 1000), (128, 1000)):
        boxes = cs.clustered_boxes(*shape, gen).to("cuda")
        want = b2.nms_keep_mask_batch(boxes, 0.5)
        same = {k: bool(torch.equal(m.nms_keep_mask_batch(boxes, 0.5), want))
                for k, m in nms.items()}
        calls = {k: (lambda m=m: m.nms_keep_mask_batch(boxes, 0.5))
                 for k, m in nms.items()}
        report("b2", (*shape, 4), same, in_turns(calls, 50))
    for batch in (8, 128):
        y, scale, shift = cs.stem_case((batch, *cs.STEM), gen, "cuda")
        want = b7.gn_relu_maxpool(y, scale, shift)
        same = {k: bool(torch.equal(m.gn_relu_maxpool(y, scale, shift), want))
                for k, m in stem.items()}
        calls = {k: (lambda m=m: m.gn_relu_maxpool(y, scale, shift))
                 for k, m in stem.items()}
        report("b7", (batch, *cs.STEM), same,
               in_turns(calls, 20 if batch == 8 else 5))
        del y, scale, shift, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
