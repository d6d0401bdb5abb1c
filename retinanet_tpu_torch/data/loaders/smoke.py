"""Loader smoke/viz CLI (a copy of ``retinanet_tpu/data/loaders/smoke.py``;
reference ``data_loaders/*`` ``__main__`` blocks and
``data_loaders/debug.py``): iterate a loader end-to-end, report stats, and
optionally render the first samples with their ground-truth boxes.

Usage::

    python -m retinanet_tpu_torch.data.loaders.smoke --dataset shapes /tmp/x 10 256
    python -m retinanet_tpu_torch.data.loaders.smoke --dataset coco ann.json imgs \
        --render /tmp/viz --limit 100
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from retinanet_tpu_torch.data.loaders.inferred import Inferred


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, nargs="+", required=True)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--render", type=str, default=None,
                        help="directory to write box-overlay PNGs")
    args = parser.parse_args(argv)

    loader = Inferred(args.dataset[0], args.dataset[1:])
    print(f"classes ({loader.num_classes}): {loader.class_names}")

    t0 = time.time()
    boxes_total = 0
    for i, sample in enumerate(loader):
        if args.limit is not None and i >= args.limit:
            break
        boxes_total += sample["boxes"].shape[0]
        if args.render and i < 8:
            try:
                import cv2
                from retinanet_tpu_torch.data.pipeline import _imread
                from retinanet_tpu_torch.utils.draw import draw_bounding_boxes
            except ImportError:
                continue
            image = sample.get("image")
            if image is None:
                image = _imread(sample["image_file"])
            h, w = image.shape[:2]
            rel = sample["boxes"] / np.array([h, w, h, w], np.float32)
            drawn = draw_bounding_boxes(image, rel, sample["class_ids"],
                                        loader.class_names)
            os.makedirs(args.render, exist_ok=True)
            cv2.imwrite(os.path.join(args.render, f"sample_{i}.png"),
                        drawn[..., ::-1])
    n = i + 1 if args.limit is None or i < args.limit else i
    dt = time.time() - t0
    print(f"iterated {n} samples ({boxes_total} boxes) in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.1f} samples/s)")


if __name__ == "__main__":
    main()
