"""Detection CLI: checkpoint or serving artifact + image files →
annotated PNGs + JSON (the port of ``retinanet_tpu/detect.py``), on the
card unless ``--device`` says otherwise.

    python -m retinanet_tpu_torch.detect img1.jpg img2.png \
        --experiment /tmp/exp --backbone resnet_50_dense --scale 256 \
        --class-names square,triangle,circle --out /tmp/det
    python -m retinanet_tpu_torch.detect img1.jpg img2.png \
        --from-export model.npz --out /tmp/det --dump-json /tmp/det.json

Images are read with cv2 or PIL, and ``--out`` is written with PIL.
Each image gets the training pipeline's
resize/pad geometry (``data.pipeline.process_sample``), and boxes map back
to original-image pixels via the recorded per-image scale.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


class _Names:
    """Minimal loader stand-in for load_detector (class names/count only)."""

    def __init__(self, class_names: List[str]):
        self.class_names = class_names
        self.num_classes = len(class_names)


def _resolve_class_names(args) -> List[str]:
    if args.class_names:
        return [c.strip() for c in args.class_names.split(",") if c.strip()]
    if args.dataset:
        from retinanet_tpu_torch.data.loaders.inferred import Inferred
        return Inferred(args.dataset[0], args.dataset[1:]).class_names
    raise SystemExit("need --class-names or --dataset to label detections")


def _load_batch(paths: List[str], image_size: int):
    """Resize/pad each image with the training geometry; returns
    (normalized canvases [N,S,S,3] f32, scales [N], original RGB images)."""
    from retinanet_tpu_torch.config import DataConfig
    from retinanet_tpu_torch.data.pipeline import _imread, process_sample

    dcfg = DataConfig()
    mean = np.asarray(dcfg.mean, np.float32)
    std = np.asarray(dcfg.std, np.float32)
    canvases, scales, originals = [], [], []
    for path in paths:
        original = _imread(path)
        sample = {"image": original,
                  "boxes": np.zeros((0, 4), np.float32),
                  "class_ids": np.zeros((0,), np.int32)}
        out = process_sample(sample, image_size, mean, std,
                             max_boxes=1, flip=False)
        canvases.append(out["image"])
        scales.append(out["scale"])
        originals.append(original)
    return (np.stack(canvases), np.asarray(scales, np.float32), originals)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="run a trained detector on image files")
    parser.add_argument("images", nargs="+", help="image files (jpg/png)")
    parser.add_argument("--experiment", type=str, default=None,
                        help="experiment dir whose checkpoint to serve")
    parser.add_argument(
        "--from-export", type=str, default=None, metavar="PATH.npz",
        help="serve from a single-file export; backbone/scale/class names "
             "come from the artifact")
    parser.add_argument("--backbone", type=str, default="resnet_50")
    parser.add_argument("--scale", type=int, default=None,
                        help="serving canvas size (default 600, or the "
                             "export artifact's recorded size)")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the latest)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="images per inference batch")
    parser.add_argument(
        "--class-names", type=str, default=None,
        help="comma-separated class names, with --experiment (the export "
             "carries its own)")
    parser.add_argument(
        "--dataset", type=str, nargs="+", default=None,
        help="alternative to --class-names, with --experiment")
    parser.add_argument(
        "--score-threshold", type=float, default=0.5,
        help="display threshold on reported detections (the reference's "
             "0.5 — NOT the mAP decode threshold)")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=["none", "int8"])
    parser.add_argument("--approx-top-k", action="store_true",
                        help="sets NMSConfig.use_approx_top_k (exact on "
                             "the port)")
    parser.add_argument("--out", type=str, default=None,
                        help="directory for annotated PNGs (skip to only "
                             "print/dump JSON)")
    parser.add_argument("--dump-json", type=str, default=None,
                        help="write all detections as one JSON file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (default cuda)")
    args = parser.parse_args(argv)

    if args.from_export is None and args.experiment is None:
        raise SystemExit("need --experiment (checkpoint dir) or "
                         "--from-export (serving artifact)")

    from retinanet_tpu_torch.config import Config, _apply_dotted
    scale = args.scale
    if scale is None:
        scale = 600
        if args.from_export:
            from retinanet_tpu_torch.export import read_meta
            scale = int(read_meta(args.from_export)["image_size"])

    config = Config()
    for dotted, value in [
        ("data.image_size", scale),
        ("data.batch_size", args.batch_size),
        ("model.backbone", args.backbone),
        ("model.quantize", args.quantize),
        ("train.experiment", args.experiment or ""),
        ("nms.score_threshold", args.score_threshold),
        ("nms.use_approx_top_k", bool(args.approx_top_k)),
    ]:
        config = _apply_dotted(config, dotted, value)

    if args.from_export:
        from retinanet_tpu_torch.export import load_exported_detector
        detector = load_exported_detector(args.from_export, config=config,
                                          device=args.device)
        class_names = detector.class_names
    else:
        class_names = _resolve_class_names(args)
        from retinanet_tpu_torch.evaluate import load_detector
        detector = load_detector(config, _Names(class_names), args.step,
                                 device=args.device)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        from PIL import Image

        from retinanet_tpu_torch.utils.draw import draw_bounding_boxes

    all_detections = []
    used_names: Dict[str, int] = {}
    # Don't pad a short image list up to the full --batch-size: one photo
    # through a batch of 8 would waste 8x the FLOPs.
    bs = min(args.batch_size, len(args.images))
    for start in range(0, len(args.images), bs):
        chunk = args.images[start:start + bs]
        canvases, scales, originals = _load_batch(chunk, scale)
        if len(chunk) < bs:  # pad the last chunk to the batch shape
            pad = bs - len(chunk)
            canvases = np.concatenate(
                [canvases, np.zeros((pad,) + canvases.shape[1:],
                                    canvases.dtype)])
            scales = np.concatenate([scales, np.ones((pad,), np.float32)])
        results = detector.detect(canvases, scales)[:len(chunk)]
        for path, original, det in zip(chunk, originals, results):
            ih, iw = original.shape[:2]
            records = []
            for (t, l, b, r), score, cid in zip(
                    det["boxes"], det["scores"], det["class_ids"]):
                records.append({
                    "image": path,
                    "class": class_names[int(cid)],
                    "score": float(score),
                    "box_tlbr": [float(t), float(l), float(b), float(r)],
                })
            all_detections.extend(records)
            logger.info("%s: %d detections", path, len(records))
            for rec in records:
                logger.info("  %-16s %.3f  %s", rec["class"], rec["score"],
                            [round(v, 1) for v in rec["box_tlbr"]])
            if args.out:
                rel = det["boxes"] / np.asarray([ih, iw, ih, iw], np.float32)
                annotated = draw_bounding_boxes(
                    original, rel, det["class_ids"], class_names,
                    scores=det["scores"])
                base = os.path.splitext(os.path.basename(path))[0]
                # Inputs from different directories can share a basename;
                # suffix repeats so no requested output is overwritten.
                k = used_names.get(base, 0)
                used_names[base] = k + 1
                name = (f"{base}.det.png" if k == 0
                        else f"{base}-{k}.det.png")
                Image.fromarray(annotated).save(os.path.join(args.out, name))

    if args.dump_json:
        with open(args.dump_json, "w") as f:
            json.dump(all_detections, f, indent=1)
        logger.info("wrote %d detections to %s", len(all_detections),
                    args.dump_json)
    return all_detections


if __name__ == "__main__":
    main()
