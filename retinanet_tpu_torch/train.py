"""Training step (port of ``retinanet_tpu/train.py``: ``TrainState``,
``build_schedule``, ``build_optimizer``, ``make_train_step``,
``create_train_state`` and ``benchmark_train``).

One step on the model's device:

    normalize → on-device label assignment → forward (``training=True``:
    B1/B3 on the identity blocks under ``fused_train``, float32 logits)
    → losses + L2 → backward → global-norm clip → optimizer update

The schedules and optimizers are written from optax's formulas (momentum
SGD, rmsprop, adam, ``clip_by_global_norm``), not taken from
``torch.optim``: optax's rmsprop puts eps inside the square root and scales
by the learning rate before its momentum trace.  Unlike JAX, the port
updates the parameters and the optimizer buffers in place: the state's
parameters are the model's own, and one step allocates no second copy.
``Trainer.fit``, checkpoints and the data pipeline are later slices.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from retinanet_tpu_torch.config import Config, TrainConfig
from retinanet_tpu_torch.models.layers import use_group_norm_kernel
from retinanet_tpu_torch.models.retinanet import RetinaNet, l2_regularization
from retinanet_tpu_torch.ops import assign
from retinanet_tpu_torch.ops import boxes as box_ops
from retinanet_tpu_torch.ops.anchors import (Levels, build_levels,
                                             flat_anchor_maps)
from retinanet_tpu_torch.ops.losses import detection_loss
from retinanet_tpu_torch.ops.preprocess import maybe_normalize
from retinanet_tpu_torch.utils.pytree import flatten_levels
from retinanet_tpu_torch.utils.summaries import prob_histograms

Schedule = Callable[[int], float]
_LOSS_KEYS = ("total_loss", "class_loss", "regr_loss", "regularization_loss")


@dataclasses.dataclass
class TrainState:
    """Step count, the model's parameters (by state_dict name) and the
    optimizer state (its update count and per-parameter buffers)."""

    step: int
    params: Dict[str, Tensor]
    opt_state: Dict[str, object]


def _f32(x: float) -> np.float32:
    return np.float32(x)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: init → end over ``steps``, then flat."""
    if steps <= 0:
        return lambda count: float(init)

    def schedule(count: int) -> float:
        c = _f32(min(max(count, 0), steps))
        frac = _f32(1) - c / _f32(steps)
        return float((_f32(init) - _f32(end)) * frac + _f32(end))

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = _f32(min(count, decay_steps))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                            / _f32(decay_steps)))
        decayed = (_f32(1) - _f32(alpha)) * cos + _f32(alpha)
        return float(_f32(init) * decayed)

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules`` of two schedules at one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def build_schedule(cfg: TrainConfig) -> Schedule:
    """Learning rate at an update count: constant, cosine, warmup_cosine or
    cyclical, as optax computes them in float32."""
    base, floor = cfg.learning_rate, cfg.learning_rate * cfg.min_lr_fraction
    if cfg.schedule == "constant":
        return lambda count: float(_f32(base))
    if cfg.schedule == "cosine":
        return _cosine(base, cfg.schedule_steps, cfg.min_lr_fraction)
    if cfg.schedule == "warmup_cosine":
        alpha = 0.0 if base == 0.0 else floor / base
        return _join(_linear(floor, base, cfg.warmup_steps),
                     _cosine(base, cfg.schedule_steps - cfg.warmup_steps,
                             alpha), cfg.warmup_steps)
    if cfg.schedule == "cyclical":
        half = max(1, cfg.schedule_steps // 2)
        return _join(_linear(floor, base, half), _linear(base, floor, half),
                     half)
    raise ValueError(f"invalid schedule {cfg.schedule!r}")


def global_norm(tensors: List[Tensor]) -> Tensor:
    """sqrt of Σ over tensors of Σx², in float32 (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


class Optimizer:
    """optax's momentum SGD (``sgd(lr, momentum)``), ``rmsprop(lr, decay,
    momentum)`` and ``adam(lr)``, chained after ``clip_by_global_norm``
    when ``grad_clip_norm`` is set.

    ``init`` gives the zero state of ``tx.init``; ``update`` takes the
    gradients in parameter order, advances the state in place and returns
    the updates to add to the parameters.
    """

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("momentum", "rmsprop", "adam"):
            raise ValueError(f"invalid optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = build_schedule(cfg)
        self._buffers = {"momentum": ("trace",), "rmsprop": ("nu", "trace"),
                         "adam": ("mu", "nu")}[cfg.optimizer]

    def init(self, params: List[Tensor]) -> Dict[str, object]:
        state: Dict[str, object] = {"count": 0}
        for name in self._buffers:
            state[name] = [torch.zeros_like(p) for p in params]
        return state

    def update(self, grads: List[Tensor], state: Dict[str, object]
               ) -> List[Tensor]:
        cfg = self.cfg
        if cfg.grad_clip_norm is not None:
            norm = global_norm(grads)
            if not bool(norm < cfg.grad_clip_norm):
                grads = [g / norm * cfg.grad_clip_norm for g in grads]
        count = state["count"]
        neg_lr = -_f32(self.schedule(count))
        updates = []
        for i, g in enumerate(grads):
            if cfg.optimizer == "momentum":
                trace = state["trace"][i]
                trace.mul_(cfg.momentum).add_(g)  # g + m·trace
                updates.append(float(neg_lr) * trace)
            elif cfg.optimizer == "rmsprop":
                nu, trace = state["nu"][i], state["trace"][i]
                nu.copy_((1 - cfg.rmsprop_decay) * (g * g)
                         + cfg.rmsprop_decay * nu)
                scaled = float(neg_lr) * (torch.rsqrt(nu + 1e-8) * g)
                trace.copy_(scaled + cfg.rmsprop_momentum * trace)
                updates.append(trace.clone())
            else:
                b1, b2, eps = 0.9, 0.999, 1e-8
                mu, nu = state["mu"][i], state["nu"][i]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                t = count + 1
                mu_hat = mu / float(_f32(1) - _f32(b1) ** t)
                nu_hat = nu / float(_f32(1) - _f32(b2) ** t)
                updates.append(float(neg_lr) * (mu_hat / (torch.sqrt(nu_hat)
                                                          + eps)))
        state["count"] = count + 1
        return updates


def build_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def _decoded_box_iou_sums(regr_targets: Tensor, regr_logits: Tensor,
                          anchor_maps: Tensor,
                          fg_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ IoU·fg, Σ fg) of decoded predicted vs target boxes on foreground
    anchors; ``anchor_maps`` [N, 4] flat (cy, cx, h, w)."""
    def decode(regr: Tensor) -> Tensor:
        pos, log_size = regr.split(2, dim=-1)
        a_pos, a_size = anchor_maps.split(2, dim=-1)
        center = pos * a_size + a_pos
        size = torch.exp(log_size) * a_size
        return box_ops.from_center_box(torch.cat([center, size], dim=-1))

    iou = box_ops.iou(decode(regr_targets), decode(regr_logits))
    w = fg_mask.to(torch.float32)
    return torch.sum(iou * w), torch.sum(w)


def _class_iou_sums(targets: Tensor, probs: Tensor,
                    mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(intersection, union) sums of the classmap thresholded at 0.5 vs
    the targets over trainable anchors."""
    pred = (probs > 0.5).to(torch.float32)
    w = mask.to(torch.float32)[..., None]
    return (torch.sum(pred * targets * w),
            torch.sum(torch.maximum(pred, targets) * w))


def make_train_step(model: RetinaNet, levels: Levels, config: Config,
                    with_metrics: bool = True):
    """Build ``step_fn(state, images, boxes, class_ids, box_mask,
    generator) -> (state, metrics)`` for a model on its device.

    ``images`` [B,H,W,3] (normalized float, or uint8), ``boxes`` [B,M,4],
    ``class_ids`` and ``box_mask`` [B,M], all on the model's device.
    ``generator`` is the step's dropout stream; no layer of
    ``resnet_50_dense`` draws from it.  ``with_metrics=False`` skips the
    diagnostics (histograms, IoU metrics, fg count).  ``grad_accum > 1``
    runs that many micro-batches and averages their gradients and loss
    scalars; the diagnostics stay full-batch sums.  Metrics are device
    tensors: the step does not synchronise with the host unless clipping
    decides on the gradient norm.
    """
    if config.model.quantize != "none":
        raise ValueError(
            f"model.quantize={config.model.quantize!r} is serving-only "
            "(quantized convs have zero gradients); train with "
            "quantize='none' and quantize at inference time")
    tx = build_optimizer(config.train)
    accum = max(1, config.train.grad_accum)
    num_classes = model.num_classes

    def micro_fn(params: List[Tensor], images: Tensor, boxes: Tensor,
                 class_ids: Tensor, box_mask: Tensor):
        image_hw = tuple(images.shape[1:3])
        images = maybe_normalize(images, config.data)
        with torch.no_grad():
            cls_t, regr_t, masks = assign.build_labels_batch(
                boxes, class_ids, box_mask, image_hw, levels, num_classes,
                config.assign)
            ct, rt, tm = (flatten_levels(cls_t), flatten_levels(regr_t),
                          flatten_levels(masks))
        out = model(images, training=True)
        cl = flatten_levels(out["classifications"])
        rg = flatten_levels(out["regressions"])
        class_loss, regr_loss = detection_loss(ct, cl, rt, rg, tm,
                                               config.loss)
        reg_loss = l2_regularization(model.named_parameters(),
                                     config.model.backbone,
                                     config.loss.weight_decay)
        total = class_loss + regr_loss + reg_loss
        grads = torch.autograd.grad(total, params)
        sums = {"total_loss": total.detach(),
                "class_loss": class_loss.detach(),
                "regr_loss": regr_loss.detach(),
                "regularization_loss": reg_loss.detach()}
        if with_metrics:
            with torch.no_grad():
                cl, rg = cl.detach(), rg.detach()
                probs = torch.sigmoid(cl)
                fg_mask = (torch.amax(ct, dim=-1) > 0.5) & tm
                anchor_maps = torch.from_numpy(
                    flat_anchor_maps(levels, image_hw)).to(cl.device)
                inter, union = _class_iou_sums(ct, probs, tm)
                iou_sum, iou_w = _decoded_box_iou_sums(rt, rg, anchor_maps,
                                                       fg_mask)
                sums.update({
                    "num_fg": fg_mask.sum(),
                    "_class_inter": inter, "_class_union": union,
                    "_regr_iou_sum": iou_sum, "_regr_iou_w": iou_w,
                    **prob_histograms(ct, probs, tm),
                })
        return list(grads), sums

    def step_fn(state: TrainState, images: Tensor, boxes: Tensor,
                class_ids: Tensor, box_mask: Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[TrainState, Dict[str, Tensor]]:
        params = list(state.params.values())
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum={accum}")
        mb = b // accum
        grads, sums = None, None
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            g, s = micro_fn(params, images[part], boxes[part],
                            class_ids[part], box_mask[part])
            if grads is None:
                grads, sums = g, s
            else:
                grads = [a + c for a, c in zip(grads, g)]
                sums = {k: sums[k] + s[k] for k in sums}
        if accum > 1:
            grads = [g / accum for g in grads]
            sums = {k: (v / accum if k in _LOSS_KEYS else v)
                    for k, v in sums.items()}

        grad_norm = global_norm(grads)
        learning_rate = tx.schedule(state.step)
        with torch.no_grad():
            for p, u in zip(params, tx.update(grads, state.opt_state)):
                p.add_(u)

        metrics = {k: sums[k] for k in _LOSS_KEYS}
        metrics.update({"grad_norm": grad_norm,
                        "learning_rate": torch.tensor(learning_rate)})
        if with_metrics:
            metrics.update({
                "num_fg": sums["num_fg"],
                "class_iou": sums["_class_inter"] / torch.clamp(
                    sums["_class_union"], min=1.0),
                "regr_iou": sums["_regr_iou_sum"] / torch.clamp(
                    sums["_regr_iou_w"], min=1.0),
                "prob_fg_hist": sums["prob_fg_hist"],
                "prob_bg_hist": sums["prob_bg_hist"],
            })
        return TrainState(state.step + 1, state.params,
                          state.opt_state), metrics

    return step_fn


def create_train_state(model: RetinaNet, config: Config,
                       params: Mapping[str, Tensor]) -> TrainState:
    """Load ``params`` (a state_dict from ``export.init_params`` or
    ``export.params_from_flax``) into the model and start the optimizer
    state at zeros, as ``tx.init`` does.  The state's parameters are the
    model's own tensors."""
    model.load_state_dict(params)
    named = dict(model.named_parameters())
    opt_state = build_optimizer(config.train).init(list(named.values()))
    return TrainState(0, named, opt_state)


def synthetic_batch(batch_size: int, image_size: int, max_boxes: int,
                    device: Union[str, torch.device]
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The fixed batch of ``benchmark_train``: normal images from
    ``RandomState(0)`` and two boxes per image of class 0."""
    rng = np.random.RandomState(0)
    images = rng.randn(batch_size, image_size, image_size, 3).astype(
        np.float32)
    boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    boxes[:, 0] = [0.2, 0.2, 0.7, 0.7]
    boxes[:, 1] = [0.5, 0.4, 0.9, 0.8]
    mask = np.zeros((batch_size, max_boxes), bool)
    mask[:, :2] = True
    ids = np.zeros((batch_size, max_boxes), np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (images, boxes, ids, mask))


def benchmark_train(config: Config, batch_size: int = 32, steps: int = 10,
                    warmup: int = 2, num_classes: int = 80,
                    device: Union[str, torch.device] = "cuda",
                    group_norm_kernel: bool = False) -> Dict[str, float]:
    """Train-step throughput (assignment + forward + backward + optimizer)
    on a fixed synthetic batch and seeded weights, and the peak device
    memory of the steps; ``group_norm_kernel`` routes every GroupNorm's
    forward through kernel B4 (``use_group_norm_kernel``).  Needs a CUDA
    device: a time taken on the CPU is not the card's."""
    from retinanet_tpu_torch.export import init_params

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_train times the card; got device "
                           f"{device}")
    levels = build_levels(config.anchors)
    model = RetinaNet.from_config(config.model, levels.num_anchors,
                                  num_classes=num_classes).to(device)
    use_group_norm_kernel(model, group_norm_kernel)
    state = create_train_state(
        model, config,
        init_params(config, torch.Generator().manual_seed(0), num_classes))
    step_fn = make_train_step(model, levels, config, with_metrics=False)
    batch = synthetic_batch(batch_size, config.data.image_size,
                            config.assign.max_boxes, device)
    gen = torch.Generator(device).manual_seed(1)

    torch.cuda.reset_peak_memory_stats(device)
    metrics = None
    for _ in range(warmup):
        state, metrics = step_fn(state, *batch, gen)
    metrics["total_loss"].item()

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, *batch, gen)
    loss = metrics["total_loss"].item()
    total = time.perf_counter() - t0
    return {
        "images_per_sec": batch_size * steps / total,
        "step_ms": total / steps * 1e3,
        "batch_size": batch_size,
        "image_size": config.data.image_size,
        "peak_memory_bytes": float(torch.cuda.max_memory_allocated(device)),
        "final_loss": loss,
        "finite": math.isfinite(loss),
    }
