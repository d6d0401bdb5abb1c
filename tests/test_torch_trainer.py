"""The port's training loop (``retinanet_tpu_torch.train``: ``Trainer``
and ``CheckpointStore``, with ``evaluate.load_detector``'s checkpoint
averaging) on the CPU (``device="cpu"``): the flagship at 64 px, fp32,
dropout 0, batch 2, on the shapes dataset.  The CLIs and the metrics
writer are in ``test_torch_train_cli.py``, ``make_classmap_fn`` and
``--init-backbone`` in ``test_torch_pretrained.py``.

One JAX initialisation and one JAX compile of the full-metrics step serve
the file (module fixture ``jax_run``): JAX's ``create_train_state``
parameters, written as the port's step-0 checkpoint, are where a two-step
``Trainer.fit`` of the port starts, and JAX's step is driven by hand on
the batches of JAX's own training pipeline from the same seed.  The
port's fits share one module fixture too (``port_fit``)."""

import contextlib
import json
import logging
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu import config as jcfg
from retinanet_tpu.data.loaders.shapes import Shapes as JaxShapes
from retinanet_tpu.data.pipeline import build_pipeline as jax_pipeline
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.train import create_train_state as jax_init
from retinanet_tpu.train import make_train_step as jax_step
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch import evaluate, train
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import init_params, params_from_flax
from retinanet_tpu_torch.train import (CheckpointStore, TrainState, Trainer,
                                       create_train_state)

torch.set_num_threads(2)

SIZE, BATCH, IMAGES, STEPS = 64, 2, 8, 2
LOSSES = ("total_loss", "class_loss", "regr_loss", "regularization_loss")


def _fields(experiment, **train):
    """The config of every run here, as keyword arguments of both
    packages' dataclasses."""
    return dict(
        model=dict(backbone="resnet_50_dense", num_classes=3,
                   dropout_rate=0.0, compute_dtype="float32"),
        data=dict(dataset=("shapes", "unused", str(IMAGES), str(SIZE)),
                  image_size=SIZE, batch_size=BATCH, num_workers=2),
        assign=dict(max_boxes=8),
        train=dict(experiment=str(experiment), log_every=1, **train))


def _config(module, experiment, **train):
    kw = _fields(experiment, **train)
    return module.Config(
        model=module.ModelConfig(**kw["model"]),
        data=module.DataConfig(**kw["data"]),
        assign=module.AssignConfig(**kw["assign"]),
        train=module.TrainConfig(**kw["train"]))


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(params).items()}


def _records(experiment):
    with open(os.path.join(experiment, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's create_train_state parameters and two full-metrics steps on
    the first two batches of JAX's training pipeline (seed train.seed)."""
    cfg = _config(jcfg, tmp_path_factory.mktemp("jax"))
    model = JaxRetinaNet.from_config(cfg.model, 9, 3)
    levels = jax_levels(cfg.anchors)
    state = jax.jit(lambda key: jax_init(model, cfg, key))(
        jax.random.PRNGKey(cfg.train.seed))
    flat0 = _flat(state.params)
    pipe = jax_pipeline(JaxShapes(None, IMAGES, (SIZE, SIZE)), cfg.data,
                        max_boxes=cfg.assign.max_boxes, training=True,
                        seed=cfg.train.seed)
    with contextlib.closing(pipe.prefetched(0)) as stream:
        batches = [next(stream) for _ in range(STEPS)]
    step = jax.jit(jax_step(model, levels, cfg, with_metrics=True))
    rng = jax.random.PRNGKey(cfg.train.seed + 1)
    metrics = []
    for b in batches:
        state, m = step(state, *(jnp.asarray(a) for a in (
            b.images, b.boxes, b.class_ids, b.box_mask)), rng)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return dict(flat0=flat0, flat=_flat(state.params), batches=batches,
                metrics=metrics)


def _port_config(experiment, **train):
    return _config(tcfg, experiment, **train)


def _trainer(experiment, **train):
    return Trainer(_port_config(experiment, **train),
                   loader=Shapes(None, IMAGES, (SIZE, SIZE)), device="cpu")


@pytest.fixture(scope="module")
def port_fit(jax_run, tmp_path_factory):
    """The port's two-step fit from JAX's parameters (written as its step-0
    checkpoint, with a zero momentum trace), then a second Trainer on the
    same experiment resuming 2 → 4."""
    experiment = str(tmp_path_factory.mktemp("port"))
    trainer = _trainer(experiment)
    state = create_train_state(trainer.model, trainer.config,
                               params_from_flax(jax_run["flat0"]))
    store = CheckpointStore(experiment)
    store.save(state)
    store.wait_for_checkpoints()
    fitted = trainer.fit(epochs=1, steps_per_epoch=STEPS)
    after = {k: v.detach().clone() for k, v in fitted.params.items()}
    records = _records(experiment)
    trace = [t.clone() for t in fitted.opt_state["trace"]]

    resumed = _trainer(experiment)
    handler, log = _Capture(), logging.getLogger(train.__name__)
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        resumed_state = resumed.fit(epochs=1, steps_per_epoch=STEPS)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    yield dict(experiment=experiment, after=after,
               trace=trace, step=fitted.step, records=records,
               resumed=resumed_state, log=handler.messages,
               all_records=_records(experiment), trainer=resumed)
    shutil.rmtree(experiment)  # a checkpoint here holds ~300 MB


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_two_step_fit_matches_jax(jax_run, port_fit):
    """Each logged loss ≤1e-4 relative and grad_norm ≤1e-3
    (``tests/test_torch_train.py``'s fp32 step bounds); the parameters'
    total update p₂ − p₀ within 1e-2 relative L2 over all parameters and
    5e-2 per parameter (measured 3.0e-3 and ≤1.3e-2).

    The per-element bound of ``test_torch_train.py`` (1e-3 of a leaf's
    largest update, for one step on He-scaled weights) cannot hold here:
    from JAX's initialisation (FPN and heads at N(0, 0.01), so the FPN's
    GroupNorm variances sit near eps) fp32 summation order moves the
    second step's update by up to 1.3% of a leaf's largest element between
    two runs of the port itself (1 and 2 CPU threads; 1.8e-4 relative L2
    overall)."""
    assert port_fit["step"] == STEPS
    assert [r["step"] for r in port_fit["records"]] == [1, 2]
    for got, want in zip(port_fit["records"], jax_run["metrics"]):
        for key in LOSSES:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=key)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-3)
        assert got["num_fg"] == float(want["num_fg"])
    before = params_from_flax(jax_run["flat0"])
    want = params_from_flax(jax_run["flat"])
    assert set(port_fit["after"]) == set(want)
    diff = total = 0.0
    for name, p0 in before.items():
        want_u = (want[name] - p0).double()
        err = (port_fit["after"][name] - p0).double() - want_u
        assert err.norm() <= 5e-2 * want_u.norm(), name
        diff += float(err.square().sum())
        total += float(want_u.square().sum())
    assert diff ** 0.5 <= 1e-2 * total ** 0.5


def test_step_zero_checkpoint_holds_jax_parameters(jax_run, port_fit):
    """The checkpoint the fit started from holds JAX's parameters bitwise,
    read back by the params-only restore."""
    want = params_from_flax(jax_run["flat0"])
    got = CheckpointStore(port_fit["experiment"]).restore_params(want, 0)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_resumed_fit_continues_the_step_count(port_fit):
    assert "restored checkpoint from step 2" in port_fit["log"]
    assert port_fit["resumed"].step == 2 * STEPS
    assert [r["step"] for r in port_fit["all_records"]] == [1, 2, 3, 4]
    assert port_fit["trainer"].checkpoint_steps() == [0, 2, 4]


def test_checkpoint_round_trip_is_bitwise(port_fit, tmp_path):
    """Restore step 2 into fresh tensors: the step, every parameter and
    every momentum buffer bitwise those the fit returned; the model and
    the state share storage after it."""
    trainer = _trainer(port_fit["experiment"])
    state = create_train_state(trainer.model, trainer.config,
                               trainer.model.state_dict())
    params = dict(state.params)
    got = trainer.restore_checkpoint(state, step=STEPS)
    assert got.step == STEPS and got.opt_state["count"] == STEPS
    for k, v in port_fit["after"].items():
        assert torch.equal(got.params[k].detach(), v), k
        assert got.params[k] is params[k]
    for a, b in zip(got.opt_state["trace"], port_fit["trace"]):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="latest available: 4"):
        trainer.restore_checkpoint(state, step=3)


def _tiny_state(scale, step, optimizer="momentum", clip=None):
    params = {"a.kernel": torch.arange(6.0).reshape(2, 3) * scale,
              "b.bias": torch.full((4,), 0.5) * scale}
    cfg = tcfg.TrainConfig(optimizer=optimizer, grad_clip_norm=clip)
    opt = train.build_optimizer(cfg).init(list(params.values()))
    for buffers in (v for v in opt.values() if isinstance(v, list)):
        for t in buffers:
            t.fill_(scale)
    return TrainState(step, params, opt)


def test_retention_keeps_the_newest(tmp_path):
    """keep_checkpoints=2 of 4 saves keeps steps 3 and 4, and a restore
    takes the newest; a restore-only store never prunes, and a half-written
    (tmp-named) step is not listed."""
    store = CheckpointStore(str(tmp_path), keep_checkpoints=2)
    for step in range(1, 5):
        store.save(_tiny_state(float(step), step))
    assert store.checkpoint_steps() == [3, 4]
    state = store.restore(_tiny_state(0.0, 0))
    assert state.step == 4 and state.opt_state["count"] == 0
    assert torch.equal(state.params["b.bias"], torch.full((4,), 2.0))
    assert torch.equal(state.opt_state["trace"][0], torch.full((2, 3), 4.0))
    os.makedirs(os.path.join(store.checkpoint_dir, "step_9.tmp-1"))
    reader = CheckpointStore(str(tmp_path), keep_checkpoints=1)
    assert reader.checkpoint_steps() == [3, 4]
    reader.restore(_tiny_state(0.0, 0), step=3)
    reader.wait_for_checkpoints()
    assert reader.checkpoint_steps() == [3, 4]


def test_restore_params_ignores_the_optimizer(tmp_path):
    """A checkpoint of an adam run with --grad-clip-norm serves through
    ``restore_params`` (its optimizer file is never read), where a full
    restore into a momentum state refuses the other structure."""
    store = CheckpointStore(str(tmp_path))
    store.save(_tiny_state(2.0, 7, optimizer="adam", clip=1.0))
    store.wait_for_checkpoints()
    template = _tiny_state(0.0, 0).params
    got = CheckpointStore(str(tmp_path)).restore_params(template)
    assert torch.equal(got["a.kernel"], torch.arange(6.0).reshape(2, 3) * 2)
    os.remove(os.path.join(store.checkpoint_dir, "step_7", "opt_state.pt"))
    assert torch.equal(store.restore_params(template, 7)["b.bias"],
                       torch.ones(4))
    store.save(_tiny_state(2.0, 8, optimizer="adam", clip=1.0))
    with pytest.raises(ValueError, match="optimizer state"):
        store.restore(_tiny_state(0.0, 0), step=8)


@pytest.mark.parametrize("restore", ["restore", "restore_params"])
def test_explicit_step_restore_joins_the_write_in_flight(tmp_path,
                                                         monkeypatch,
                                                         restore):
    """A restore of a given step right after this store saved it reads the
    whole step, however slow the background write (here held back until
    the restore has been called)."""
    called, real_save = threading.Event(), torch.save

    def slow_save(obj, path):
        called.wait(timeout=5)
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", slow_save)
    store = CheckpointStore(str(tmp_path))
    store.save(_tiny_state(3.0, 5))
    threading.Timer(0.2, called.set).start()
    if restore == "restore":
        got = store.restore(_tiny_state(0.0, 0), step=5).params
    else:
        got = store.restore_params(_tiny_state(0.0, 0).params, step=5)
    assert called.is_set()
    assert torch.equal(got["b.bias"], torch.full((4,), 1.5))


def test_average_checkpoints_serves_the_mean(tmp_path):
    """--average-checkpoints 2 of 1× and 3× parameters serves 2×, and
    raises "mutually exclusive" together with --step."""
    config = _port_config(tmp_path)
    base = init_params(config, torch.Generator().manual_seed(0), 3)
    store = CheckpointStore(str(tmp_path))
    for scale, step in ((1.0, 1), (3.0, 2)):
        store.save(TrainState(step, {k: v * scale for k, v in base.items()},
                              {"count": 0}))
    store.wait_for_checkpoints()
    loader = Shapes(None, 1, (SIZE, SIZE))
    served = evaluate.load_detector(config, loader, average_last=2,
                                    device="cpu").model.state_dict()
    shutil.rmtree(store.checkpoint_dir)
    for k, v in base.items():
        assert torch.equal(served[k], (v + v * 3.0) / 2.0), k
        torch.testing.assert_close(served[k], 2.0 * v, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        evaluate.load_detector(config, loader, step=1, average_last=2,
                               device="cpu")


@pytest.fixture(scope="module")
def seeded_fits(tmp_path_factory):
    """Two fresh one-step fits from train.seed, in two experiments."""
    runs = []
    for name in ("a", "b"):
        experiment = str(tmp_path_factory.mktemp(f"seeded_{name}"))
        trainer = _trainer(experiment)
        state = trainer.fit(epochs=1, steps_per_epoch=1)
        runs.append((trainer, state, _records(experiment)))
    yield runs
    for trainer, _, _ in runs:
        shutil.rmtree(trainer.config.train.experiment)


def test_fits_from_one_seed_are_bitwise_equal(seeded_fits):
    (_, s1, r1), (_, s2, r2) = seeded_fits
    assert [r["step"] for r in r1] == [1]
    for a, b in zip(r1, r2):
        for key in LOSSES + ("grad_norm", "prob_fg_hist"):
            assert a[key] == b[key], key
    for k, v in s1.params.items():
        assert torch.equal(v, s2.params[k]), k


def test_steps_per_epoch_leaks_no_threads(seeded_fits):
    """Each epoch's ``steps_per_epoch`` break closes the pipeline's
    producer thread and worker pool (``tests/test_train.py``'s leak test,
    at 3 epochs of 1 step)."""
    trainer = seeded_fits[0][0]
    before = threading.active_count()
    state = trainer.fit(epochs=3, steps_per_epoch=1)
    assert state.step == 1 + 3
    assert threading.active_count() <= before, (
        before, threading.active_count())


def test_image_summaries_write_every_overlay(seeded_fits):
    """GT and predicted box overlays and the per-level classmap heat maps
    of the first two images of a batch, as PNG files under
    ``summaries/step_N`` and TensorBoard images (cv2 draws them)."""
    pytest.importorskip("cv2")
    trainer, state, _ = seeded_fits[1]
    with contextlib.closing(trainer.pipeline.prefetched(0)) as stream:
        batch = next(stream)
    trainer.write_image_summaries(state, batch)
    out = os.path.join(trainer.config.train.experiment, "summaries",
                       f"step_{state.step}")
    want = {f"{i}_{kind}.png" for i in (0, 1) for kind in ("true", "pred")}
    want |= {f"{i}_classmap_{pn}_{kind}.png" for i in (0, 1)
             for pn in ("P3", "P4", "P5", "P6", "P7")
             for kind in ("true", "pred")}
    assert set(os.listdir(out)) == want
