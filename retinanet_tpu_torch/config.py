"""Typed configuration of the port (its own copy of ``retinanet_tpu/config.py``).

The same frozen dataclasses with the same fields and defaults, so a run of
the port is described by the same values as a run of the JAX package
(``tests/test_torch_config.py`` holds them equal field by field), and the
helpers ``_apply_dotted`` and ``parse_buckets`` that the CLIs build a
config with.  Left out: ``ParallelConfig`` (the device mesh; the
data-parallel slice brings its own) and the CLI parser
``config_from_args`` (the CLI slice).  Comments on what
each field does on the TPU stay with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
class Config:
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    assign: AssignConfig = dataclasses.field(default_factory=AssignConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    nms: NMSConfig = dataclasses.field(default_factory=NMSConfig)

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
