"""Training (port of ``retinanet_tpu/train.py``): the step
(``TrainState``, ``build_schedule``, ``build_optimizer``,
``make_train_step``, ``create_train_state``), the loop around it
(``CheckpointStore``, ``Trainer``, ``make_classmap_fn``), its benchmarks
(``benchmark_train``, ``benchmark_train_pipeline``) and the CLI (``main``).

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
So a checkpoint copies every tensor to the host before the next step runs
and writes the files on a background thread, and a restore copies into
the live tensors.

Several ranks (``torchrun``, one device each, ``parallel/distributed.py``)
train one model on the global batch: ``make_train_step(group=)`` sums the
loss's statistics over the ranks (``ops/losses.py``) and the gradients in
one flat bucket, and ``Trainer`` feeds each rank its shard of the dataset,
writes metrics and checkpoints on the lead rank only, and restores every
rank from the shared directory.  ``--spatial`` (image height over
devices) waits for ROADMAP A.7's second part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import shutil
import threading
import time
from typing import (Callable, Dict, Iterator, List, Mapping, Optional, Tuple,
                    Union)

import numpy as np
import torch
from torch import Tensor

from retinanet_tpu_torch.config import Config, TrainConfig, parse_args
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.data.pipeline import Batch, build_pipeline
from retinanet_tpu_torch.models.layers import (DropoutKeys,
                                               use_group_norm_kernel)
from retinanet_tpu_torch.models.retinanet import (RetinaNet, l2_regularization,
                                                  l2_scale)
from retinanet_tpu_torch.ops import assign
from retinanet_tpu_torch.ops import boxes as box_ops
from retinanet_tpu_torch.ops.anchors import (Levels, build_levels,
                                             flat_anchor_maps)
from retinanet_tpu_torch.ops.losses import detection_loss
from retinanet_tpu_torch.ops.preprocess import maybe_normalize
from retinanet_tpu_torch.parallel import distributed
from retinanet_tpu_torch.utils.pytree import flatten_levels
from retinanet_tpu_torch.utils.summaries import (MetricsWriter,
                                                 prob_histograms, to_host)

logger = logging.getLogger(__name__)

SPATIAL = "ROADMAP A.7, second part (--spatial)"
Schedule = Callable[[int], float]
_LOSS_KEYS = ("total_loss", "class_loss", "regr_loss", "regularization_loss")
# The diagnostics' sums, summed over the ranks before the ratios are taken.
_SUMMED_KEYS = ("num_fg", "_class_inter", "_class_union", "_regr_iou_sum",
                "_regr_iou_w", "prob_fg_hist", "prob_bg_hist")


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


def make_classmap_fn(model: RetinaNet, levels: Levels, config: Config):
    """``fn(images, boxes, class_ids, box_mask) -> (true, pred)``: per
    level, the GT and predicted fg (anchor, class) counts per cell [B,H,W]
    for the classmap heat overlays (reference ``train.py:52-66``: the
    classmap thresholded at prob 0.5), from the model's forward in eval
    mode (``training=False``, no autograd)."""

    @torch.no_grad()
    def fn(images: Tensor, boxes: Tensor, class_ids: Tensor,
           box_mask: Tensor):
        images = maybe_normalize(images, config.data)
        out = model(images, training=False)
        cls_t, _, _ = assign.build_labels_batch(
            boxes, class_ids, box_mask, tuple(images.shape[1:3]), levels,
            model.num_classes, config.assign)
        # The sigmoid in the head's dtype, as JAX's jax.nn.sigmoid.
        pred = {pn: torch.sum(torch.sigmoid(c) > 0.5, dim=(-2, -1))
                for pn, c in out["classifications"].items()}
        true = {pn: torch.sum(t > 0.5, dim=(-2, -1))
                for pn, t in cls_t.items()}
        return true, pred

    return fn


def make_train_step(model: RetinaNet, levels: Levels, config: Config,
                    with_metrics: bool = True, group=None):
    """Build ``step_fn(state, images, boxes, class_ids, box_mask,
    generator) -> (state, metrics)`` for a model on its device.

    ``images`` [B,H,W,3] (normalized float, or uint8), ``boxes`` [B,M,4],
    ``class_ids`` and ``box_mask`` [B,M], all on the model's device.
    ``generator`` is the step's dropout stream: each forward (each
    micro-batch) draws one seed from it (``models/layers.DropoutKeys``),
    which every dropout site folds with its index, so a recomputation
    under ``remat`` draws the same masks.  A CPU generator draws without
    synchronising with the card.  MobileNetV2 and DenseNet need it when
    their dropout rate is above 0; the ResNet-50 backbones have no
    dropout.  ``with_metrics=False`` skips the
    diagnostics (histograms, IoU metrics, fg count).  ``grad_accum > 1``
    runs that many micro-batches and averages their gradients and loss
    scalars; the diagnostics stay full-batch sums.  Metrics are device
    tensors: the step does not synchronise with the host unless clipping
    decides on the gradient norm.

    ``group`` (a ``torch.distributed`` group; the counterpart of the JAX
    package's ``make_shard_map_train_step``): the batch is this rank's
    slice of the global batch, and the step is the one-process step on
    the global batch.  The losses' sums run over the ranks
    (``detection_loss(group=)``); the data loss's parameter gradients and
    the diagnostics' sums are summed over the ranks once a step, in one
    flat bucket; the L2 term's gradient is added once, after.  So every
    metric is global, the clipping decision is taken on the summed
    gradient and the parameters stay bitwise equal across ranks.  With
    ``grad_accum = k``, micro-batch j is the union of every rank's j-th
    chunk.  Each rank draws the dropout masks of its own slice: rank 0
    from ``generator`` as one process does, rank r from a generator
    seeded by the same draw folded with r.
    """
    if config.model.quantize != "none":
        raise ValueError(
            f"model.quantize={config.model.quantize!r} is serving-only "
            "(quantized convs have zero gradients); train with "
            "quantize='none' and quantize at inference time")
    tx = build_optimizer(config.train)
    accum = max(1, config.train.grad_accum)
    num_classes = model.num_classes
    rank = 0 if group is None else group.rank()
    decay = [l2_scale(name, config.model.backbone, config.loss.weight_decay)
             for name, _ in model.named_parameters()]

    def dropout_stream(generator: Optional[torch.Generator]
                       ) -> Optional[torch.Generator]:
        """This rank's dropout generator for one forward.  Every rank takes
        one draw from ``generator`` a forward, so the streams stay in
        step."""
        if generator is None or rank == 0 or not model.dropout_sites:
            return generator
        return DropoutKeys.draw(generator).generator(rank,
                                                     torch.device("cpu"))

    def micro_fn(params: List[Tensor], images: Tensor, boxes: Tensor,
                 class_ids: Tensor, box_mask: Tensor,
                 generator: Optional[torch.Generator]):
        image_hw = tuple(images.shape[1:3])
        images = maybe_normalize(images, config.data)
        with torch.no_grad():
            cls_t, regr_t, masks = assign.build_labels_batch(
                boxes, class_ids, box_mask, image_hw, levels, num_classes,
                config.assign)
            ct, rt, tm = (flatten_levels(cls_t), flatten_levels(regr_t),
                          flatten_levels(masks))
        out = model(images, training=True, generator=dropout_stream(generator))
        cl = flatten_levels(out["classifications"])
        rg = flatten_levels(out["regressions"])
        class_loss, regr_loss = detection_loss(ct, cl, rt, rg, tm,
                                               config.loss, group)
        grads = torch.autograd.grad(class_loss + regr_loss, params)
        sums = {"class_loss": class_loss.detach(),
                "regr_loss": regr_loss.detach()}
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
                            class_ids[part], box_mask[part], generator)
            if grads is None:
                grads, sums = g, s
            else:
                grads = [a + c for a, c in zip(grads, g)]
                sums = {k: sums[k] + s[k] for k in sums}
        with torch.no_grad():
            if group is not None:
                summed = [k for k in _SUMMED_KEYS if k in sums]
                reduced = distributed.all_reduce_sum(
                    grads + [sums[k].to(torch.float32) for k in summed],
                    group)
                grads = reduced[:len(grads)]
                sums.update({k: v.to(sums[k].dtype) for k, v in
                             zip(summed, reduced[len(grads):])})
            if accum > 1:
                grads = [g / accum for g in grads]
                sums = {k: (v / accum if k in _LOSS_KEYS else v)
                        for k, v in sums.items()}
            reg_loss = l2_regularization(state.params.items(),
                                         config.model.backbone,
                                         config.loss.weight_decay)
            for g, p, scale in zip(grads, params, decay):
                if scale:
                    g.add_(p, alpha=scale)

            grad_norm = global_norm(grads)
            learning_rate = tx.schedule(state.step)
            for p, u in zip(params, tx.update(grads, state.opt_state)):
                p.add_(u)

        metrics = {"total_loss": sums["class_loss"] + sums["regr_loss"]
                   + reg_loss,
                   "class_loss": sums["class_loss"],
                   "regr_loss": sums["regr_loss"],
                   "regularization_loss": reg_loss,
                   "grad_norm": grad_norm,
                   "learning_rate": torch.tensor(learning_rate)}
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


_PARAMS_FILE, _OPT_FILE = "params.pt", "opt_state.pt"


def _host_copy(tensors):
    """A host copy of every tensor in a (nested) list or dict."""
    if isinstance(tensors, Tensor):
        return tensors.detach().to("cpu", copy=True)
    if isinstance(tensors, dict):
        return {k: _host_copy(v) for k, v in tensors.items()}
    if isinstance(tensors, list):
        return [_host_copy(v) for v in tensors]
    return tensors


@torch.no_grad()
def _copy_into(live, saved, what: str) -> None:
    """Copy ``saved`` into the ``live`` tensors of the same structure."""
    if isinstance(live, Tensor):
        if not isinstance(saved, Tensor) or saved.shape != live.shape:
            raise ValueError(f"checkpoint {what}: expected a tensor of shape "
                             f"{tuple(live.shape)}, found {saved!r:.80}")
        live.copy_(saved)
        return
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint {what}: keys differ from the "
                             f"model's")
        for k in live:
            _copy_into(live[k], saved[k], f"{what}/{k}")
        return
    if not isinstance(saved, list) or len(saved) != len(live):
        raise ValueError(f"checkpoint {what}: expected {len(live)} entries")
    for i, (a, b) in enumerate(zip(live, saved)):
        _copy_into(a, b, f"{what}/{i}")


class CheckpointStore:
    """Experiment-directory checkpoint access, decoupled from the Trainer.

    The Trainer composes one for training; evaluate/export/detect construct
    one directly, so serving-side restores don't inherit training-only
    validations.  Layout: ``<experiment>/checkpoints/step_N/`` holding
    ``params.pt`` (the step and the parameters by state_dict name) and
    ``opt_state.pt`` (the step and the optimizer state), torch files read
    with ``torch.load(weights_only=True)``; a params-only restore
    (``restore_params``) never opens the optimizer's file.

    Retention keeps the newest ``keep_checkpoints`` finalized ``step_N``
    dirs and only ever runs after a save from THIS store — a restore-only
    store (evaluate) never prunes someone else's experiment.

    ``save`` copies every tensor to the host before it returns (the step
    updates them in place), then writes the files on one background
    thread into a directory whose name holds ``tmp`` and renames it to
    ``step_N`` when complete, so ``_finalized_steps`` never lists a
    half-written step.  ``wait_for_checkpoints`` joins the write.

    Under several ranks the experiment directory is shared: only the lead
    (``is_lead``) writes and prunes, and every rank restores.  The store
    holds no collective: the Trainer meets its ranks at a barrier after the
    lead's write is joined, so that no rank reads a step before it is whole.
    """

    def __init__(self, experiment: str, keep_checkpoints: int = 5,
                 is_lead: bool = True):
        self.experiment = experiment
        self.keep_checkpoints = keep_checkpoints
        self.is_lead = is_lead
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._saved = False

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(os.path.abspath(self.experiment), "checkpoints")

    def save(self, state: TrainState):
        """Host copy now, files in the background; at most one write in
        flight (a second save first joins the first).

        Pruning runs AFTER the write is started and only touches finalized
        ``step_N`` directories, always retaining the newest
        ``keep_checkpoints`` of them — so even with ``keep_checkpoints=1`` a
        crash or a failed write never leaves zero restorable checkpoints.
        A rank other than the lead writes nothing.
        """
        self._join()
        if not self.is_lead:
            return
        step = int(state.step)
        host = {"params": {"step": step,
                           "params": _host_copy(dict(state.params))},
                "opt": {"step": step,
                        "opt_state": _host_copy(dict(state.opt_state))}}
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        self._writer = threading.Thread(target=self._write,
                                        args=(host, path), daemon=True)
        self._writer.start()
        self._saved = True
        logger.info("saving checkpoint at step %d", step)
        self._prune(keep=max(1, self.keep_checkpoints))

    def _write(self, host: Dict[str, dict], path: str) -> None:
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host["params"], os.path.join(tmp, _PARAMS_FILE))
            torch.save(host["opt"], os.path.join(tmp, _OPT_FILE))
            if os.path.isdir(path):  # a second save of one step replaces it
                old = f"{path}.tmp-old-{os.getpid()}"
                os.rename(path, old)
                os.rename(tmp, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, path)
        except BaseException as err:  # re-raised by _join in the caller
            self._write_error = err

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("checkpoint write failed") from err

    def _finalized_steps(self) -> list:
        """Finalized step_N dirs on disk, ascending (no wait for a write in
        flight — safe to call from pruning)."""
        if not os.path.isdir(self.checkpoint_dir):
            return []
        steps = []
        for name in os.listdir(self.checkpoint_dir):
            if name.startswith("step_") and "tmp" not in name:
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def _prune(self, keep: int):
        steps = self._finalized_steps()
        for step in steps[:-keep] if keep > 0 else steps:
            shutil.rmtree(
                os.path.join(self.checkpoint_dir, f"step_{step}"),
                ignore_errors=True)

    def wait_for_checkpoints(self):
        self._join()
        # Now that the write in flight is finalized, enforce the exact
        # retention count (save-time pruning keeps one extra while the
        # newest save is still tmp-named).  Restore-only stores have
        # nothing in flight and must never prune.
        if self._saved:
            self._prune(keep=max(1, self.keep_checkpoints))

    def checkpoint_steps(self) -> list:
        """All finalized checkpoint steps, ascending (waits for a write in
        flight first)."""
        self.wait_for_checkpoints()
        return self._finalized_steps()

    def latest_checkpoint_step(self) -> Optional[int]:
        steps = self.checkpoint_steps()
        return max(steps) if steps else None

    def _load(self, step: int, name: str) -> dict:
        return torch.load(os.path.join(self.checkpoint_dir, f"step_{step}",
                                       name),
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy the latest (or the given) checkpoint into ``state``'s live
        tensors, so the model and the state keep sharing storage.  A write
        of this store still in flight is joined first."""
        self._join()
        explicit = step is not None
        step = step if step is not None else self.latest_checkpoint_step()
        if step is None:
            return state
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        if explicit and not os.path.isdir(path):
            available = self.latest_checkpoint_step()
            raise FileNotFoundError(
                f"no checkpoint at step {step} in {self.checkpoint_dir} "
                f"(latest available: {available})")
        params = self._load(step, _PARAMS_FILE)["params"]
        opt = self._load(step, _OPT_FILE)
        _copy_into(dict(state.params), params, "params")
        saved_opt = opt["opt_state"]
        if set(saved_opt) != set(state.opt_state):
            raise ValueError(f"checkpoint optimizer state {sorted(saved_opt)}"
                             f" differs from the run's "
                             f"{sorted(state.opt_state)}")
        for key, live in state.opt_state.items():
            if isinstance(live, list):
                _copy_into(live, saved_opt[key], f"opt_state/{key}")
            else:
                state.opt_state[key] = saved_opt[key]
        logger.info("restored checkpoint from step %d", step)
        return TrainState(int(opt["step"]), state.params, state.opt_state)

    def restore_params(self, params: Mapping[str, Tensor],
                       step: Optional[int] = None) -> Dict[str, Tensor]:
        """Params-only restore for SERVING (evaluate/export/detect): the
        parameters of the latest (or the given) checkpoint as new host
        tensors, checked against ``params`` by name and shape; ``params``
        itself when there is no checkpoint.  The optimizer's file is never
        read, so how the model was optimized (``--grad-clip-norm``, the
        optimizer) does not matter to serving.  A write of this store still
        in flight is joined first."""
        self._join()
        step = step if step is not None else self.latest_checkpoint_step()
        if step is None:
            return dict(params)
        restored = self._load(step, _PARAMS_FILE)["params"]
        if set(restored) != set(params):
            raise ValueError(
                f"checkpoint step {step} holds parameters "
                f"{sorted(set(restored) ^ set(params))[:3]}... that the "
                f"model does not (or the reverse)")
        for k, v in params.items():
            if tuple(restored[k].shape) != tuple(v.shape):
                raise ValueError(f"checkpoint step {step}: {k} has shape "
                                 f"{tuple(restored[k].shape)}, the model "
                                 f"{tuple(v.shape)}")
        logger.info("restored params from step %d", step)
        return restored


def refuse_distributed(config: Config) -> None:
    """Raise ``NotImplementedError`` for the runs the port does not spread:
    ``spatial > 1`` (ROADMAP A.7, second part), and a ``num_devices`` other
    than the number of ranks (one process over several devices; a rank
    drives one device, so ``torchrun --nproc-per-node N`` gives N)."""
    if config.parallel.spatial > 1:
        raise NotImplementedError(
            f"spatial={config.parallel.spatial} (image height over a "
            f"device mesh) waits for {SPATIAL}")
    devices, world = config.parallel.num_devices, distributed.world_size()
    if devices is not None and devices != world:
        raise NotImplementedError(
            f"num_devices={devices} in a run of {world} process(es): a "
            f"process drives one device (ROADMAP A.7), so launch N "
            f"processes with `torchrun --nproc-per-node N`")


class _Staged:
    """One batch on its way to the device: the pinned host tensors, the
    device tensors and the copy's event."""

    def __init__(self, host: Tuple[Tensor, ...], device: Tuple[Tensor, ...],
                 event: Optional["torch.cuda.Event"]):
        self.host, self.device, self.event = host, device, event

    def ready(self) -> Tuple[Tensor, ...]:
        """The device tensors, usable on the current stream: it waits for
        the copy, and the allocator learns that the stream uses them."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device[0].device)
            stream.wait_event(self.event)
            for t in self.device:
                t.record_stream(stream)
        return self.device

    def release(self) -> None:
        """Drop the host buffers once the copy has ended."""
        if self.event is not None:
            self.event.synchronize()
        self.host = None


class HostToDevice:
    """Batches to one device.  On a CUDA device each batch is pinned and
    copied on a side stream, so the copy of batch k+1 runs while step k
    does; on the CPU the arrays are wrapped as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def stage(self, batch: Batch) -> _Staged:
        arrays = (batch.images, batch.boxes, batch.class_ids, batch.box_mask)
        host = tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays)
        if self._stream is None:
            return _Staged(host, tuple(t.to(self.device) for t in host),
                           None)
        host = tuple(t.pin_memory() for t in host)
        with torch.cuda.stream(self._stream):
            device = tuple(t.to(self.device, non_blocking=True)
                           for t in host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(host, device, event)

    def stream(self, batches) -> Iterator[Tuple[Tuple[Tensor, ...], Batch]]:
        """(device_batch, host_batch) with one batch of copy lookahead:
        batch k+1's copy is issued before batch k is yielded."""
        pending = None
        for batch in batches:
            staged = self.stage(batch)
            if pending is not None:
                yield pending[0].ready(), pending[1]
                pending[0].release()
            pending = (staged, batch)
        if pending is not None:
            yield pending[0].ready(), pending[1]
            pending[0].release()


class Trainer:
    """Epoch loop + checkpoints + metrics (reference ``train.py:246-277``)
    on this rank's device: the card unless the caller passes another.

    Under several ranks (``parallel.distributed.initialize``, which the
    Trainer calls for a launcher's environment if ``train.main`` did not)
    ``config.data.batch_size`` is the global batch: each rank feeds
    global/world images a step from its shard of the dataset
    (``shard_loader``), with pipeline seed ``train.seed + rank`` and the
    canvas schedule every rank shares (``scheduled_canvases``); every rank
    takes the same number of steps an epoch, set from the global dataset
    length; the initial state is broadcast from rank 0; metrics, image
    summaries and checkpoint writes are the lead's alone.
    """

    def __init__(self, config: Config, loader=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        distributed.initialize(device)
        refuse_distributed(config)
        world, rank = distributed.world_size(), distributed.rank()
        self.is_lead, self.group = rank == 0, distributed.group()
        if config.data.batch_size % world:
            raise ValueError(
                f"global batch {config.data.batch_size} not divisible by "
                f"{world} processes")
        local_data = dataclasses.replace(
            config.data, batch_size=config.data.batch_size // world)
        if config.train.grad_accum > 1 and (
                local_data.batch_size % config.train.grad_accum):
            raise ValueError(
                f"batch {local_data.batch_size} (a rank's) not divisible by "
                f"grad_accum={config.train.grad_accum}")
        if loader is None:
            loader = Inferred(config.data.dataset[0],
                              list(config.data.dataset[1:]))
        self.loader = loader
        self.device = distributed.rank_device(device)
        self.levels = build_levels(config.anchors)
        self.model = RetinaNet.from_config(
            config.model, num_anchors=self.levels.num_anchors,
            num_classes=loader.num_classes).to(self.device)
        # Shards differ by at most one sample and the pipeline drops a short
        # last batch, so ranks could differ by a batch an epoch and the
        # longer one would wait in a collective forever: every rank takes
        # the smallest shard's batches, from the GLOBAL dataset length.
        self._sync_steps_per_epoch = None
        if world > 1:
            try:
                self._sync_steps_per_epoch = (
                    len(loader) // world // local_data.batch_size)
            except TypeError:  # an unsized loader: set steps_per_epoch
                pass
        self.pipeline = build_pipeline(
            distributed.shard_loader(loader, rank, world), local_data,
            max_boxes=config.assign.max_boxes, training=True,
            seed=config.train.seed + rank, scheduled_canvases=world > 1,
            schedule_seed=config.train.seed)
        self.transfer = HostToDevice(self.device)
        self.writer = (MetricsWriter(config.train.experiment)
                       if self.is_lead else None)
        self.checkpoints = CheckpointStore(config.train.experiment,
                                           config.train.keep_checkpoints,
                                           is_lead=self.is_lead)
        self._infer_fn = None

    # -- checkpointing (delegates to CheckpointStore) ------------------------
    @property
    def checkpoint_dir(self) -> str:
        return self.checkpoints.checkpoint_dir

    def save_checkpoint(self, state: TrainState):
        self.checkpoints.save(state)

    def wait_for_checkpoints(self):
        """Join this rank's write, then meet every rank: past it, the lead's
        checkpoints are whole and pruned for every rank to read."""
        self.checkpoints.wait_for_checkpoints()
        distributed.barrier()

    def checkpoint_steps(self) -> list:
        return self.checkpoints.checkpoint_steps()

    def latest_checkpoint_step(self) -> Optional[int]:
        return self.checkpoints.latest_checkpoint_step()

    def restore_checkpoint(self, state: TrainState,
                           step: Optional[int] = None) -> TrainState:
        return self.checkpoints.restore(state, step)

    # -- image summaries -----------------------------------------------------
    def write_image_summaries(self, state: TrainState, batch: Batch):
        """GT vs predicted box overlays + classmap heat maps as PNGs under
        ``<experiment>/summaries/step_N`` and TensorBoard images
        (reference ``build_summary`` / ``draw_classmap``,
        ``train.py:52-85,164-187``), for the first two images of a host
        batch; nothing without cv2."""
        try:
            import cv2
        except ImportError:
            return  # before any device work: cv2-less hosts pay nothing
        from retinanet_tpu_torch.infer import make_inference_fn
        from retinanet_tpu_torch.utils.draw import (draw_bounding_boxes,
                                                    draw_classmap)

        if self._infer_fn is None:
            self._infer_fn = make_inference_fn(
                self.model, self.levels, self.config)
            self._classmap_fn = make_classmap_fn(
                self.model, self.levels, self.config)
        n_draw = min(2, batch.images.shape[0])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[:n_draw])).to(
                self.device)

        images_dev = put(batch.images)
        out = [t.cpu().numpy() for t in self._infer_fn(images_dev)]
        boxes, scores, class_ids, valid = out
        cm_true, cm_pred = (
            {pn: v.cpu().numpy() for pn, v in maps.items()}
            for maps in self._classmap_fn(images_dev, put(batch.boxes),
                                          put(batch.class_ids),
                                          put(batch.box_mask)))
        step = int(state.step)
        out_dir = os.path.join(self.config.train.experiment, "summaries",
                               f"step_{step}")
        os.makedirs(out_dir, exist_ok=True)
        mean = np.asarray(self.config.data.mean)
        std = np.asarray(self.config.data.std)
        names = self.loader.class_names

        def to_tb(tag, rgb):
            if self.writer is None:
                return
            ok, png = cv2.imencode(".png", (rgb[..., ::-1]))
            if ok:
                self.writer.add_image_png(tag, png.tobytes(),
                                          rgb.shape[0], rgb.shape[1], step)

        for i in range(n_draw):
            if batch.images.dtype == np.uint8:  # device-normalized batches
                img = batch.images[i].astype(np.float32) / 255.0
            else:
                img = np.clip(batch.images[i] * std + mean, 0, 1)
            gt_valid = batch.box_mask[i]
            gt = draw_bounding_boxes(img, batch.boxes[i][gt_valid],
                                     batch.class_ids[i][gt_valid], names)
            cv2.imwrite(os.path.join(out_dir, f"{i}_true.png"),
                        gt[..., ::-1])
            to_tb(f"boxes/{i}_true", gt)
            pv = valid[i]
            pred = draw_bounding_boxes(img, boxes[i][pv], class_ids[i][pv],
                                       names, scores=scores[i][pv])
            cv2.imwrite(os.path.join(out_dir, f"{i}_pred.png"),
                        pred[..., ::-1])
            to_tb(f"boxes/{i}_pred", pred)
            # Per-level classmap heat overlays (reference train.py:52-66,
            # 176-187): count of fg anchor-class slots per cell, GT vs
            # predicted.
            for pn in cm_true:
                heat_t = draw_classmap(img, cm_true[pn][i])
                heat_p = draw_classmap(img, cm_pred[pn][i])
                cv2.imwrite(
                    os.path.join(out_dir, f"{i}_classmap_{pn}_true.png"),
                    heat_t[..., ::-1])
                to_tb(f"classmap/{i}_{pn}_true", heat_t)
                cv2.imwrite(
                    os.path.join(out_dir, f"{i}_classmap_{pn}_pred.png"),
                    heat_p[..., ::-1])
                to_tb(f"classmap/{i}_{pn}_pred", heat_p)

    # -- training ----------------------------------------------------------
    def _device_batches(self, epoch: int):
        """(device_batch, host_batch) stream with one batch of copy
        lookahead (``HostToDevice.stream``; reference analog:
        ``prefetch(1)`` at ``train.py:202``)."""
        return self.transfer.stream(self.pipeline.prefetched(epoch))

    def _initial_state(self) -> TrainState:
        """Seeded weights (``train.seed``), the backbone from
        ``init_backbone`` on a fresh start, then the latest checkpoint."""
        from retinanet_tpu_torch.export import init_params

        cfg = self.config
        self.wait_for_checkpoints()  # every rank reads whole checkpoints
        params = init_params(cfg, torch.Generator().manual_seed(
            cfg.train.seed), self.loader.num_classes)
        if cfg.train.init_backbone and self.latest_checkpoint_step() is None:
            # Fresh start only: a resumed checkpoint always wins over the
            # imported init (its backbone already trained past it).
            from retinanet_tpu_torch.utils.pretrained import load_pretrained
            params, report = load_pretrained(
                params, cfg.train.init_backbone, backbone=cfg.model.backbone)
            if report is not None:
                logger.info(
                    "init backbone from %s: %d by-name + %d by-shape "
                    "matches, 0 unmatched", cfg.train.init_backbone,
                    len(report["matched_by_name"]),
                    len(report["matched_by_shape"]))
            else:
                logger.info("init backbone from %s (exact npz restore)",
                            cfg.train.init_backbone)
        state = self.restore_checkpoint(
            create_train_state(self.model, cfg, params))
        if self.group is not None:
            distributed.broadcast_(
                list(state.params.values())
                + [t for v in state.opt_state.values()
                   if isinstance(v, list) for t in v], group=self.group)
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None) -> TrainState:
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.train.epochs
        steps_per_epoch = (steps_per_epoch if steps_per_epoch is not None
                           else cfg.train.steps_per_epoch)
        if steps_per_epoch is None:
            steps_per_epoch = self._sync_steps_per_epoch
        elif self._sync_steps_per_epoch is not None:
            steps_per_epoch = min(steps_per_epoch, self._sync_steps_per_epoch)
        state = self._initial_state()
        py_step = int(state.step)

        # Two variants: the hot-path step skips the diagnostic full-tensor
        # reductions; the full step runs only on logged steps.
        step_light = make_train_step(self.model, self.levels, cfg,
                                     with_metrics=False, group=self.group)
        step_full = make_train_step(self.model, self.levels, cfg,
                                    with_metrics=True, group=self.group)
        # The steps' dropout seeds, drawn on the host (no synchronisation).
        step_gen = torch.Generator().manual_seed(cfg.train.seed + 1)
        t_last = time.time()
        steps_since_log = 0  # actual steps elapsed since t_last: the first
        # logged step (step 1, which also pays the warm-up) divides by 1,
        # not log_every, so metrics.jsonl never starts with a made-up rate
        # Optional torch.profiler capture of N steps (train.profile_steps /
        # --profile N) on the lead, from the third step of this run on, past
        # the first call of each step variant.
        profile_from = (py_step + 3 if cfg.train.profile_steps > 0
                        and self.is_lead else None)
        profile_dir = os.path.join(cfg.train.experiment, "profile")
        profiler = None
        for epoch in range(epochs):
            logger.info("epoch %d", epoch)
            # closing(): a steps-per-epoch break must unwind the pipeline
            # generators deterministically (producer thread + worker pool),
            # not whenever GC notices (Pipeline.prefetched).
            with contextlib.closing(self._device_batches(epoch)) as batches:
              for i, (device_batch, batch) in enumerate(batches):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                step = py_step + 1
                if profile_from is not None and profiler is None \
                        and step == profile_from:
                    self._sync()
                    profiler = _start_profiler(self.device)
                    logger.info("profiling %d steps -> %s",
                                cfg.train.profile_steps, profile_dir)
                # Log on cadence and always on the first step, so short runs
                # still produce metrics records.
                will_log = step % cfg.train.log_every == 0 or step == 1
                step_fn = step_full if will_log else step_light
                state, metrics = step_fn(state, *device_batch, step_gen)
                py_step = step
                steps_since_log += 1
                if profiler is not None and step >= profile_from \
                        + cfg.train.profile_steps - 1:
                    self._sync()
                    _stop_profiler(profiler, profile_dir, profile_from, step)
                    profiler, profile_from = None, None

                if will_log and self.is_lead:
                    metrics = to_host(metrics)
                    now = time.time()
                    metrics["images_per_sec"] = (
                        cfg.data.batch_size * steps_since_log
                        / max(now - t_last, 1e-9))
                    t_last = now
                    steps_since_log = 0
                    self.writer.write(step, metrics)
                    logger.info(
                        "step %d loss %.4f (class %.4f regr %.4f reg %.4f)",
                        step, float(metrics["total_loss"]),
                        float(metrics["class_loss"]),
                        float(metrics["regr_loss"]),
                        float(metrics["regularization_loss"]))
                if step % cfg.train.checkpoint_every == 0:
                    self.save_checkpoint(state)
                    if cfg.train.image_summaries and self.is_lead:
                        self.write_image_summaries(state, batch)
        if profiler is not None:  # run ended inside the requested window
            self._sync()
            _stop_profiler(profiler, profile_dir, profile_from, py_step)
        self.save_checkpoint(state)
        self.wait_for_checkpoints()
        return state


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, first: int, last: int
                   ) -> str:
    """Stop and write the Chrome trace; returns its path."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_steps_{first}-{last}.json")
    profiler.export_chrome_trace(path)
    logger.info("wrote profile trace %s", path)
    return path


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
    gen = torch.Generator().manual_seed(1)  # dropout seeds, on the host

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


def benchmark_train_pipeline(config: Config, batch_size: int = 32,
                             steps: int = 10, warmup: int = 2,
                             num_classes: int = 80,
                             num_images: Optional[int] = None,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Dict[str, float]:
    """Train-step throughput with the LIVE host pipeline: in-memory shapes
    dataset → threaded decode/pad → uint8 batches pinned and copied on a
    side stream, double-buffered against the running step
    (``HostToDevice``).  :func:`benchmark_train` feeds the same device
    batch every step and so never measures the host and the copy; this is
    the end-to-end training number.

    ``num_classes`` defaults to 80 so the compute matches the serving
    benchmark (shapes only emits class ids 0-2; assignment is
    id-agnostic).  Needs a CUDA device: a time taken on the CPU is not the
    card's."""
    from retinanet_tpu_torch.data.loaders.shapes import Shapes
    from retinanet_tpu_torch.export import init_params

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_train_pipeline times the card; got "
                           f"device {device}")
    levels = build_levels(config.anchors)
    size = config.data.image_size
    loader = Shapes(None, num_images or max(batch_size * 4, 64),
                    (size, size))
    model = RetinaNet.from_config(config.model, levels.num_anchors,
                                  num_classes=num_classes).to(device)
    data_cfg = dataclasses.replace(config.data, batch_size=batch_size)
    pipeline = build_pipeline(loader, data_cfg,
                              max_boxes=config.assign.max_boxes,
                              training=True, seed=0)
    state = create_train_state(
        model, config,
        init_params(config, torch.Generator().manual_seed(0), num_classes))
    step_fn = make_train_step(model, levels, config, with_metrics=False)
    gen = torch.Generator().manual_seed(1)  # dropout seeds, on the host

    def batches():
        epoch = 0
        while True:
            yield from pipeline.prefetched(epoch)
            epoch += 1

    metrics = None
    with contextlib.closing(HostToDevice(device).stream(batches())) as feed:
        for _ in range(warmup):
            state, metrics = step_fn(state, *next(feed)[0], gen)
        metrics["total_loss"].item()

        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, *next(feed)[0], gen)
        metrics["total_loss"].item()
        total = time.perf_counter() - t0
    return {
        "images_per_sec": batch_size * steps / total,
        "step_ms": total / steps * 1e3,
        "batch_size": batch_size,
        "image_size": size,
    }


def main(argv=None):
    """``python -m retinanet_tpu_torch.train``: the JAX package's flags
    (``config.build_parser``), on the card unless ``--device`` says
    otherwise; under ``torchrun --nproc-per-node N`` each of N ranks on its
    own card, ``--batch-size`` the global batch."""
    from retinanet_tpu_torch.utils.cli import log_args

    logging.basicConfig(level=logging.INFO)
    config, device = parse_args(argv)
    distributed.initialize(device)
    if distributed.is_lead():
        log_args(config)
    trainer = Trainer(config, device=device)
    return trainer.fit()


if __name__ == "__main__":
    main()
