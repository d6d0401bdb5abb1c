"""Typed configuration of the port (its own copy of ``retinanet_tpu/config.py``).

The same frozen dataclasses with the same fields and defaults, so a run of
the port is described by the same values as a run of the JAX package
(``tests/test_torch_config.py`` holds them equal field by field), the
helpers ``_apply_dotted`` and ``parse_buckets`` that the CLIs build a
config with, and the training CLI's flag surface ``config_from_args``
(``--platform`` becomes ``--device``, which ``parse_args`` returns beside
the config).  ``ParallelConfig`` describes the JAX package's device mesh;
the port runs one process on one device and refuses anything larger
(``train.Trainer``) until ``torch.distributed`` lands (ROADMAP A.7).
Comments on what each field does on the TPU stay with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor pyramid: P3..P7 base sizes ``32 * 2**(k-3)`` pixels, each cell
    gets ``len(aspect_ratios) * len(scale_ratios)`` anchors."""

    min_level: int = 3
    max_level: int = 7
    base_size: int = 32
    aspect_ratios: Tuple[Tuple[float, float], ...] = ((1, 2), (1, 1), (2, 1))
    scale_ratios: Tuple[float, ...] = (2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3))

    @property
    def num_anchors(self) -> int:
        return len(self.aspect_ratios) * len(self.scale_ratios)

    @property
    def levels(self) -> Tuple[int, ...]:
        return tuple(range(self.min_level, self.max_level + 1))


@dataclasses.dataclass(frozen=True)
class AssignConfig:
    """Anchor→GT matching thresholds.  ``bg_uses_pos_threshold`` keeps the
    reference's quirk: background is ``iou < pos_iou_threshold`` while the
    trainable band is ``iou < neg or iou >= pos``."""

    neg_iou_threshold: float = 0.4
    pos_iou_threshold: float = 0.5
    bg_uses_pos_threshold: bool = True
    max_boxes: int = 100  # static padding of per-image GT boxes
    match_chunk: int = 0  # >0: match GT boxes in chunks of this size


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss mix: the summed classification terms, Huber regression on
    foreground anchors, and the L2 scale on conv kernels."""

    class_losses: Tuple[str, ...] = ("bce", "dice")
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    dice_smooth: float = 0.0
    jaccard_smooth: float = 1.0
    huber_delta: float = 1.0
    weight_decay: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model architecture and the kernel switches of the dense ResNet."""

    backbone: str = "resnet_50"
    num_classes: int = 80
    activation: str = "elu"
    dropout_rate: float = 0.2
    fpn_channels: int = 256
    head_depth: int = 4
    groupnorm_groups: int = 32
    groupnorm_eps: float = 1e-5
    prior_prob: float = 0.01
    compute_dtype: str = "bfloat16"
    quantize: str = "none"  # none | int8
    remat: bool = False
    fused_blocks: bool = False
    fused_res2: bool = False
    fused_res2_strips: int = 20
    fused_res3_strips: int = 0
    fused_res4_strips: int = 0
    fused_bwd_strip_rows: int = 20
    fused_proj: bool = False
    # Training: every stride-1 identity block runs the fused forward and the
    # hand-written backward (ops/bottleneck_bwd.py).
    fused_train: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline: canvas, batch, augmentation and normalization."""

    dataset: Tuple[str, ...] = ("shapes", "/tmp/shapes", "100", "256")
    image_size: int = 640
    buckets: Optional[Tuple[Tuple[int, int], ...]] = None
    batch_size: int = 8
    shuffle_buffer: int = 4096
    augment_flip: bool = True
    pair_flip_batching: bool = False
    augment_photometric: bool = False
    photometric_strength: float = 0.25
    augment_scale_jitter: float = 0.0
    mean: Tuple[float, float, float] = (0.46618041, 0.44669811, 0.40252436)
    std: Tuple[float, float, float] = (0.27940595, 0.27489075, 0.28920765)
    transfer_uint8: bool = True
    num_workers: int = 4
    prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, learning-rate schedule and the training loop's cadence."""

    optimizer: str = "momentum"  # momentum | adam | rmsprop
    learning_rate: float = 1e-2
    schedule: str = "constant"  # constant | cosine | warmup_cosine | cyclical
    warmup_steps: int = 500
    schedule_steps: int = 100_000
    min_lr_fraction: float = 0.01
    momentum: float = 0.9
    rmsprop_decay: float = 0.9
    rmsprop_momentum: float = 0.9
    grad_clip_norm: Optional[float] = None
    grad_accum: int = 1
    epochs: int = 1000
    steps_per_epoch: Optional[int] = None
    checkpoint_every: int = 500
    keep_checkpoints: int = 5
    log_every: int = 50
    image_summaries: bool = False
    profile_steps: int = 0
    init_backbone: Optional[str] = None
    experiment: str = "experiments/default"
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    """Detection decode.  ``use_pallas``, ``suppression`` and the
    approximate top-k switches name TPU tactics; the port computes the same
    exact greedy mask and exact top-k whatever they say."""

    score_threshold: float = 0.5
    iou_threshold: float = 0.5
    max_output_size: int = 1000
    top_k_per_level: int = 1000
    pre_nms_top_k: int = 1000
    use_pallas: bool = False
    suppression: str = "sequential"  # "sequential" | "jacobi"
    use_approx_top_k: bool = False
    approx_top_k_recall: float = 0.95
    use_approx_global_top_k: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device mesh of the JAX package: a 1-D data axis, and with
    ``spatial`` > 1 a second axis over the image height."""

    data_axis: str = "data"
    space_axis: str = "space"
    num_devices: Optional[int] = None  # None = all visible devices
    spatial: int = 1  # devices along the space (image-height) axis


@dataclasses.dataclass(frozen=True)
class Config:
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    assign: AssignConfig = dataclasses.field(default_factory=AssignConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    nms: NMSConfig = dataclasses.field(default_factory=NMSConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _apply_dotted(cfg: Config, dotted: str, value) -> Config:
    """Return a copy of ``cfg`` with ``section.field`` replaced by ``value``."""
    section_name, field_name = dotted.split(".", 1)
    section = getattr(cfg, section_name)
    section = dataclasses.replace(section, **{field_name: value})
    return dataclasses.replace(cfg, **{section_name: section})


def parse_buckets(specs) -> Tuple[Tuple[int, int], ...]:
    """Parse ``["640x640", "640x448", ...]`` HxW specs (the --buckets CLI
    surface, shared by train and evaluate)."""
    buckets = []
    for spec in specs:
        h, w = spec.lower().split("x")
        buckets.append((int(h), int(w)))
    return tuple(buckets)


def build_parser():
    """The training CLI's flags: the JAX package's ``config_from_args``
    surface (reference ``train.py:88-108`` plus the TPU-native additions),
    with ``--device`` in place of ``--platform``."""
    import argparse

    parser = argparse.ArgumentParser(description="retinanet_tpu_torch trainer")
    parser.add_argument("--learning-rate", type=float, default=1e-2)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--dataset", type=str, nargs="+", required=True)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--scale", type=int, default=600,
                        help="static square image size (reference shorter-side scale)")
    parser.add_argument("--experiment", type=str, required=True)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument(
        "--backbone", type=str, default="resnet_50",
        choices=["resnet_50", "resnet_50_dense", "densenet_121",
                 "densenet_169", "mobilenet_v2"])
    parser.add_argument(
        "--optimizer", type=str, default="momentum",
        choices=["momentum", "adam", "rmsprop"])
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument(
        "--workers", type=int, default=None,
        help="host decode threads (default: DataConfig.num_workers)")
    parser.add_argument(
        "--augment-photometric", action="store_true",
        help="random brightness/contrast/saturation jitter (host-side)")
    parser.add_argument(
        "--augment-scale-jitter", type=float, default=0.0, metavar="J",
        help="zoom-out scale jitter: resize factor multiplied by U[1-J, 1] "
             "per training image (0 = off)")
    parser.add_argument(
        "--pair-flip-batching", action="store_true",
        help="reference-parity batches: each image contributes itself AND "
             "its horizontal flip as adjacent batch entries instead of "
             "random flip; batch size must be even")
    parser.add_argument(
        "--buckets", type=str, nargs="+", default=None, metavar="HxW",
        help="rectangular canvas buckets, e.g. --buckets 640x640 640x448 "
             "448x640; each image goes to the least-padding bucket and "
             "batches are bucket-homogeneous")
    parser.add_argument(
        "--class-loss", type=str, nargs="+", default=None,
        choices=["bce", "focal", "dice", "jaccard", "fixed_iou",
                 "balanced_bce"],
        help="classification loss mix (default: bce dice, the reference's "
             "active config; 'focal' is the paper loss)")
    parser.add_argument(
        "--schedule", type=str, default="constant",
        choices=["constant", "cosine", "warmup_cosine", "cyclical"])
    parser.add_argument(
        "--warmup-steps", type=int, default=None, metavar="N",
        help="linear LR warmup length for --schedule warmup_cosine "
             "(default 500)")
    parser.add_argument(
        "--schedule-steps", type=int, default=None, metavar="N",
        help="decay horizon for cosine/warmup_cosine/cyclical schedules "
             "(default 100000; set to the planned optimizer-step count)")
    parser.add_argument(
        "--grad-accum", type=int, default=1, metavar="A",
        help="accumulate gradients over A micro-batches per optimizer step "
             "(batch-size must divide by A)")
    parser.add_argument(
        "--spatial", type=int, default=1, metavar="S",
        help="shard image height over S devices; values above 1 wait for "
             "ROADMAP A.7 (torch.distributed)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to train on (default cuda; 'cpu' runs the "
             "kernels' plain versions)")
    parser.add_argument(
        "--init-backbone", type=str, default=None, metavar="PATH",
        help="initialize the backbone from a weights file (save_backbone "
             "npz or a torch/torchvision state_dict) when starting fresh; "
             "ignored on checkpoint resume")
    parser.add_argument(
        "--fused-train", action="store_true",
        help="every identity bottleneck block of the dense ResNet on the "
             "fused forward (kernel B1) and the hand-written backward "
             "(kernel B3) when training")
    parser.add_argument(
        "--profile", type=int, default=0, metavar="N",
        help="trace N train steps from the third on with torch.profiler, "
             "as a Chrome trace under <experiment>/profile")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> Tuple[Config, str]:
    """``(config, device)`` from the training CLI's flags."""
    args = build_parser().parse_args(argv)
    cfg = Config()
    for dotted, value in [
        ("train.learning_rate", args.learning_rate),
        ("model.dropout_rate", args.dropout),
        ("data.dataset", tuple(args.dataset)),
        ("train.epochs", args.epochs),
        ("data.image_size", args.scale),
        ("train.experiment", args.experiment),
        ("train.grad_clip_norm", args.grad_clip_norm),
        ("model.backbone", args.backbone),
        ("train.optimizer", args.optimizer),
        ("data.batch_size", args.batch_size),
        ("train.steps_per_epoch", args.steps_per_epoch),
        ("train.seed", args.seed),
        ("train.schedule", args.schedule),
        ("train.log_every", args.log_every),
        ("train.profile_steps", args.profile),
        ("data.pair_flip_batching", bool(args.pair_flip_batching)),
        ("data.augment_photometric", bool(args.augment_photometric)),
        ("data.augment_scale_jitter", args.augment_scale_jitter),
        ("parallel.spatial", args.spatial),
        ("train.grad_accum", args.grad_accum),
        ("train.init_backbone", args.init_backbone),
        ("model.fused_train", bool(args.fused_train)),
    ]:
        cfg = _apply_dotted(cfg, dotted, value)
    if args.workers is not None:
        cfg = _apply_dotted(cfg, "data.num_workers", args.workers)
    if args.warmup_steps is not None:
        cfg = _apply_dotted(cfg, "train.warmup_steps", args.warmup_steps)
    if args.schedule_steps is not None:
        cfg = _apply_dotted(cfg, "train.schedule_steps", args.schedule_steps)
    if args.class_loss is not None:
        cfg = _apply_dotted(cfg, "loss.class_losses", tuple(args.class_loss))
    if args.buckets is not None:
        cfg = _apply_dotted(cfg, "data.buckets", parse_buckets(args.buckets))
    return cfg, args.device


def config_from_args(argv: Optional[Sequence[str]] = None) -> Config:
    """The Config of the training CLI's flags (``parse_args`` without the
    device)."""
    return parse_args(argv)[0]
