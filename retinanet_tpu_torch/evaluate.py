"""Evaluation CLI — mAP over a dataset from a training checkpoint or a
serving artifact (the port of ``retinanet_tpu/evaluate.py``), on the card
unless ``--device`` says otherwise.

Usage::

    python -m retinanet_tpu_torch.evaluate --dataset shapes /tmp/shapes 64 640 \
        --experiment experiments/run1 --backbone resnet_50_dense \
        --batch-size 8 --fused-blocks --fused-res2
    python -m retinanet_tpu_torch.evaluate --dataset shapes /tmp/shapes 64 640 \
        --from-export model.npz

The flags are the JAX CLI's, ``--platform`` becoming ``--device``.
Under ``torchrun --nproc-per-node N`` each rank detects its shard of the
dataset on its own card and every rank prints the metrics of the whole set
(``evaluate_model(process_shard=)``).  ``--data-parallel`` splits each
batch over the rank's devices: every visible card at one process, the
rank's own card under several.  ``--spatial`` raises, naming the ROADMAP
item that brings it (A.7, second part).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from typing import Optional, Union

import torch

from retinanet_tpu_torch.config import Config, _apply_dotted, parse_buckets
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.eval_coco import evaluate_model
from retinanet_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)

SPATIAL = "ROADMAP A.7, second part (--spatial)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="mAP of a checkpoint or serving artifact over a "
                    "dataset")
    parser.add_argument("--dataset", type=str, nargs="+", required=True)
    parser.add_argument("--experiment", type=str, default=None,
                        help="experiment dir whose checkpoints to serve")
    parser.add_argument(
        "--from-export", type=str, default=None, metavar="PATH.npz",
        help="evaluate a single-file serving artifact (an "
             "retinanet_tpu_export_v1 npz); its class set must match the "
             "dataset's")
    parser.add_argument("--scale", type=int, default=None,
                        help="eval canvas size (default 600, or the export "
                             "artifact's recorded serving size)")
    parser.add_argument("--backbone", type=str, default="resnet_50")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--buckets", type=str, nargs="+", default=None, metavar="HxW",
        help="rectangular canvas buckets, e.g. --buckets 640x640 640x448 "
             "448x640: each image evaluates on its least-padding bucket, "
             "batches are bucket-homogeneous")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--score-threshold", type=float, default=None,
                        help="post-NMS score filter on reported detections")
    parser.add_argument(
        "--decode-threshold", type=float, default=0.05,
        help="decode validity threshold; mAP integrates the PR curve over "
             "scores, so keep this low (COCO practice: 0.05)")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the latest)")
    parser.add_argument(
        "--average-checkpoints", type=int, default=None, metavar="N",
        help="evaluate the elementwise mean of the newest N checkpoints "
             "(checkpoint averaging; mutually exclusive with --step)")
    parser.add_argument(
        "--approx-top-k", action="store_true",
        help="sets NMSConfig.use_approx_top_k (a TPU unit; the port "
             "selects candidates with exact top-k)")
    parser.add_argument(
        "--approx-global-top-k", action="store_true",
        help="sets NMSConfig.use_approx_global_top_k (exact on the port)")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=["none", "int8"],
                        help="int8: post-training-quantized serving path "
                             "(same weights, backbone and FPN convs on "
                             "kernel B6)")
    parser.add_argument(
        "--fused-blocks", action="store_true",
        help="the dense ResNet's identity blocks res3-res5 on kernel B1")
    parser.add_argument(
        "--fused-res2", action="store_true",
        help="with --fused-blocks: res2's identity blocks on B1 too")
    parser.add_argument(
        "--fused-res3-strips", type=int, default=0, metavar="R",
        help="ModelConfig.fused_res3_strips (sizes TPU VMEM strips; B1 "
             "computes the same block whatever it says)")
    parser.add_argument(
        "--fused-res4-strips", type=int, default=0, metavar="R",
        help="ModelConfig.fused_res4_strips (as --fused-res3-strips)")
    parser.add_argument(
        "--data-parallel", action="store_true",
        help="split each eval batch over the local devices: every visible "
             "card at one process, the rank's own card under torchrun "
             "(the batch size must divide by their count)")
    parser.add_argument(
        "--spatial", type=int, default=1, metavar="S",
        help=f"shard image height over S devices: waits for {SPATIAL}")
    parser.add_argument(
        "--dump-detections", type=str, default=None, metavar="PATH",
        help="also write every detection in canonical COCO-results JSON "
             "([{image_id, category_id, bbox [x,y,w,h], score}])")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to serve on (default cuda; 'cpu' runs the "
             "kernels' plain versions)")
    parser.add_argument(
        "--per-class", action="store_true",
        help="also report per-class AP (COCO: mAP@[.5:.95]; VOC: VOC07)")
    parser.add_argument(
        "--protocol", type=str, default="coco", choices=["coco", "voc"],
        help="evaluation protocol: COCO (mAP@[.5:.95], area ranges, AR) or "
             "Pascal VOC (AP@0.5 with difficult-GT ignores, VOC07 11-point "
             "+ VOC12 continuous)")
    return parser


def refuse_unported(args) -> None:
    """Raise for each flag whose port has not landed, naming its item."""
    if args.spatial > 1:
        raise SystemExit(f"--spatial waits for {SPATIAL}")


def local_devices(device: Union[str, torch.device]) -> list:
    """The devices ``--data-parallel`` serves on: every visible card at one
    process, else this rank's device alone."""
    device = distributed.rank_device(device)
    cards = torch.cuda.device_count()
    if device.type == "cuda" and distributed.world_size() == 1 and cards > 1:
        return [torch.device("cuda", i) for i in range(cards)]
    return [device]


def load_detector(config: Config, loader, step: Optional[int] = None,
                  average_last: Optional[int] = None,
                  device: Union[str, torch.device] = "cuda",
                  devices: Optional[list] = None):
    """A ``Detector`` on the experiment's latest (or given) checkpoint,
    through :class:`~retinanet_tpu_torch.train.CheckpointStore` directly —
    not a Trainer, so serving inherits no training-only validation — and
    its params-only restore.

    ``average_last=N`` serves the elementwise mean of the newest N
    checkpoints' parameters, in new tensors (checkpoint averaging).
    ``loader`` gives the class names (and so the class count); ``devices``
    serves data-parallel (``infer.Detector``).
    """
    from retinanet_tpu_torch.infer import Detector
    from retinanet_tpu_torch.models.retinanet import RetinaNet
    from retinanet_tpu_torch.ops.anchors import build_levels
    from retinanet_tpu_torch.train import CheckpointStore

    store = CheckpointStore(config.train.experiment,
                            config.train.keep_checkpoints)

    def template():
        """The model's parameter names and shapes (meta tensors)."""
        with torch.device("meta"):
            return RetinaNet.from_config(
                config.model, build_levels(config.anchors).num_anchors,
                num_classes=loader.num_classes).state_dict()

    if average_last is not None and average_last > 1:
        if step is not None:
            raise ValueError("--step and --average-checkpoints are "
                             "mutually exclusive")
        steps = store.checkpoint_steps()[-average_last:]
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints in {store.checkpoint_dir}")
        if len(steps) < average_last:
            logger.warning("only %d checkpoints available for "
                           "--average-checkpoints %d", len(steps),
                           average_last)
        like = template()
        acc = None
        for s in steps:
            params = store.restore_params(like, s)
            if acc is None:
                acc = {k: v.clone() for k, v in params.items()}
            else:
                for k, v in params.items():
                    acc[k].add_(v)
        for v in acc.values():
            v.div_(float(len(steps)))
        logger.info("serving the average of checkpoints %s", steps)
        return Detector(config, acc, loader.class_names, device, devices)
    if step is not None:
        # Fail fast on a missing checkpoint, before building the model.
        path = os.path.join(store.checkpoint_dir, f"step_{step}")
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"no checkpoint at step {step} in {store.checkpoint_dir} "
                f"(latest available: {store.latest_checkpoint_step()})")
    elif store.latest_checkpoint_step() is None:
        # Without this, the caller would serve untrained weights with rc=0.
        raise FileNotFoundError(
            f"no checkpoints in {store.checkpoint_dir} — wrong "
            f"--experiment path, or the run never saved one")
    params = store.restore_params(template(), step)
    return Detector(config, params, loader.class_names, device, devices)


def strict_json(metrics: dict) -> dict:
    """nan ("no GT in this area bucket") → None, so the record is strict
    JSON."""
    return {k: (None if isinstance(v, float) and math.isnan(v) else v)
            for k, v in metrics.items()}


def build_config(args) -> Config:
    """The serving config of parsed flags; the canvas defaults to the
    export artifact's, so it evaluates under the geometry it was built
    for, and to 600 for a checkpoint."""
    from retinanet_tpu_torch.export import read_meta

    scale = args.scale
    if scale is None:
        # The export artifact records its serving canvas; honor it so the
        # artifact evaluates under the geometry it was built for.
        scale = 600
        if args.from_export:
            scale = int(read_meta(args.from_export)["image_size"])
    config = Config()
    for dotted, value in [
        ("data.dataset", tuple(args.dataset)),
        ("data.image_size", scale),
        ("data.batch_size", args.batch_size),
        ("model.backbone", args.backbone),
        ("model.quantize", args.quantize),
        ("train.experiment", args.experiment or ""),
        ("nms.score_threshold", args.decode_threshold),
        ("nms.use_approx_top_k", bool(args.approx_top_k)),
        ("nms.use_approx_global_top_k", bool(args.approx_global_top_k)),
        ("model.fused_blocks", bool(args.fused_blocks)),
        ("model.fused_res2", bool(args.fused_res2)),
        ("model.fused_res3_strips", args.fused_res3_strips),
        ("model.fused_res4_strips", args.fused_res4_strips),
    ]:
        config = _apply_dotted(config, dotted, value)
    if args.buckets is not None:
        config = _apply_dotted(config, "data.buckets",
                               parse_buckets(args.buckets))
    return config


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    config = build_config(args)
    # Under a launcher every rank detects its shard of the dataset; the
    # records are all-gathered, so every rank prints the same metrics.
    distributed.initialize(args.device)
    world = distributed.world_size()
    process_shard = (distributed.rank(), world) if world > 1 else None
    device = distributed.rank_device(args.device)
    devices = None
    if args.data_parallel:
        devices = local_devices(device)
        logger.info("data-parallel serving over %d device(s): %s",
                    len(devices), ", ".join(map(str, devices)))

    # Evaluation mode: crowd annotations become ignore regions (COCO eval
    # protocol) rather than being dropped (the training behaviour).
    loader = Inferred(args.dataset[0], args.dataset[1:], include_crowds=True)
    if args.from_export:
        if args.average_checkpoints:
            raise SystemExit("--average-checkpoints needs an experiment "
                             "checkpoint dir; a --from-export artifact "
                             "holds exactly one parameter set")
        from retinanet_tpu_torch.export import load_exported_detector
        detector = load_exported_detector(args.from_export, config=config,
                                          device=device, devices=devices)
        if list(detector.class_names) != list(loader.class_names):
            # Order matters: class ids are positional.
            raise SystemExit(
                f"export classes {detector.class_names} do not match the "
                f"dataset's {loader.class_names} (same names, same order)")
    elif args.experiment:
        detector = load_detector(config, loader, args.step,
                                 average_last=args.average_checkpoints,
                                 device=device, devices=devices)
    else:
        raise SystemExit("need --experiment (checkpoint dir) or "
                         "--from-export (serving artifact)")

    sink = None
    dump: list = []
    if args.dump_detections:
        # Contiguous class index -> original COCO category id when the
        # loader knows it (COCO json); identity otherwise.
        cat_ids = getattr(loader, "coco_category_ids", None)

        def sink(gt, det):
            image_id = gt.get("image_id")
            for (t, l, b, r), score, cls in zip(
                    det["boxes"], det["scores"], det["class_ids"]):
                cls = int(cls)
                dump.append({
                    "image_id": (int(image_id) if image_id is not None
                                 else len(dump)),
                    "category_id": (int(cat_ids[cls]) if cat_ids is not None
                                    else cls),
                    "bbox": [float(l), float(t),
                             float(r - l), float(b - t)],
                    "score": float(score),
                })

    metrics = evaluate_model(detector, loader, config,
                             max_images=args.max_images,
                             score_threshold=args.score_threshold,
                             detections_sink=sink,
                             protocol=args.protocol,
                             per_class=args.per_class,
                             process_shard=process_shard)
    if args.dump_detections and distributed.is_lead():
        with open(args.dump_detections, "w") as f:
            json.dump(dump, f)
        logger.info("wrote %d detections to %s (COCO-results format)",
                    len(dump), args.dump_detections)
    print(json.dumps(strict_json(metrics)), flush=True)
    return metrics


if __name__ == "__main__":
    main()
