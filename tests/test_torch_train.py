"""The port's training step (``retinanet_tpu_torch.train``) against JAX
``make_train_step`` on the CPU: one fp32 momentum-SGD step of the flagship
at 64 px, batch 2, 4 classes, from the same numpy-seeded parameters and
batch (one JAX trace for the file); gradient accumulation; per-block remat;
and the optimizers and schedules against optax on a toy parameter tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu.models.retinanet import l2_regularization as jax_l2
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.train import TrainState as JaxTrainState
from retinanet_tpu.train import build_optimizer as jax_optimizer
from retinanet_tpu.train import build_schedule as jax_schedule
from retinanet_tpu.train import make_train_step as jax_step
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.retinanet import RetinaNet, l2_regularization
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.train import (benchmark_train, build_optimizer,
                                       build_schedule, create_train_state,
                                       make_train_step)

from torch_parity import flagship_config, random_flat_params, to_flax

torch.set_num_threads(2)

SIZE, BATCH, CLASSES = 64, 2, 4


def _port_config(remat=False, **train) -> tcfg.Config:
    cfg = tcfg.Config(model=tcfg.ModelConfig(
        backbone="resnet_50_dense", num_classes=CLASSES,
        compute_dtype="float32", remat=remat))
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=SIZE,
                                 batch_size=BATCH),
        train=dataclasses.replace(cfg.train, **train))


def _batch(seed=0):
    """Normal images, 3 boxes of random classes per image (sides 0.35-0.7
    of the canvas, so the 64-px pyramid matches them), 100 slots."""
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    boxes = np.zeros((BATCH, 100, 4), np.float32)
    tl = rng.rand(BATCH, 3, 2) * 0.3
    boxes[:, :3] = np.concatenate([tl, tl + 0.35 + rng.rand(BATCH, 3, 2)
                                   * 0.35], -1)
    ids = np.zeros((BATCH, 100), np.int32)
    ids[:, :3] = rng.randint(0, CLASSES, (BATCH, 3))
    mask = np.zeros((BATCH, 100), bool)
    mask[:, :3] = True
    return images, boxes, ids, mask


@pytest.fixture(scope="module")
def jax_run():
    """One JAX fp32 step with metrics from numpy-seeded parameters."""
    flat = random_flat_params(flagship_config(), seed=5)
    cfg = JaxConfig(model=flagship_config())
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=SIZE,
                                               batch_size=BATCH))
    model = JaxRetinaNet.from_config(cfg.model, 9, CLASSES)
    params = to_flax(flat)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params,
                          jax_optimizer(cfg.train).init(params))
    batch = _batch()
    new_state, metrics = jax.jit(jax_step(model, jax_levels(), cfg))(
        state, *map(jnp.asarray, batch), jax.random.PRNGKey(1))
    new_flat = {"/".join(k): np.asarray(v) for k, v in
                traverse_util.flatten_dict(new_state.params).items()}
    reg = float(jax.jit(jax_l2, static_argnums=(1, 2))(
        params, "resnet_50_dense", 1e-4))
    return flat, batch, {k: np.asarray(v) for k, v in metrics.items()}, \
        new_flat, reg


def _port_step(flat, batch, with_metrics=True, remat=False, **train):
    cfg = _port_config(remat, **train)
    model = RetinaNet.from_config(cfg.model, 9, CLASSES)
    state = create_train_state(model, cfg, params_from_flax(flat))
    step = make_train_step(model, build_levels(), cfg, with_metrics)
    new_state, metrics = step(state, *map(torch.from_numpy, batch),
                              torch.Generator().manual_seed(1))
    return new_state, {k: v.numpy() for k, v in metrics.items()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's step with metrics from the same parameters and batch."""
    flat, batch, _, _, _ = jax_run
    return _port_step(flat, batch)


def test_fp32_step_matches_jax(jax_run, port_run):
    """Losses ≤1e-4 relative (fp32 sums over ~70 layers in another order,
    measured ≤1.1e-6); grad_norm ≤1e-3 relative (measured 1.6e-6) and the
    learning rate ≤1e-6; each
    parameter's update ≤1e-3 of its largest JAX update, plus two float32
    ulps of the updated parameter (the update is read back as p' − p);
    the diagnostics: num_fg and the histograms exact, IoU ratios ≤1e-4."""
    flat, batch, want, new_flat, _ = jax_run
    state, got = port_run
    assert state.step == 1
    for key in ("total_loss", "class_loss", "regr_loss",
                "regularization_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["learning_rate"], want["learning_rate"],
                               rtol=1e-6)
    assert int(got["num_fg"]) == int(want["num_fg"]) > 0
    for key in ("prob_fg_hist", "prob_bg_hist"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("class_iou", "regr_iou"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    before, after = params_from_flax(flat), params_from_flax(new_flat)
    assert set(state.params) == set(after)
    for name, p0 in before.items():
        want_u = (after[name] - p0).numpy()
        got_u = (state.params[name].detach() - p0).numpy()
        bound = (1e-3 * np.abs(want_u).max()
                 + 2 * np.spacing(np.abs(after[name].numpy()).max()))
        assert np.abs(got_u - want_u).max() <= bound, name


def test_light_step_and_l2_match_jax(jax_run):
    """``with_metrics=False`` returns the same losses and state, and
    ``l2_regularization`` agrees with JAX's to 1e-6 relative."""
    flat, batch, want, _, reg = jax_run
    state, got = _port_step(flat, batch, with_metrics=False)
    assert set(got) == {"total_loss", "class_loss", "regr_loss",
                        "regularization_loss", "grad_norm", "learning_rate"}
    np.testing.assert_allclose(got["total_loss"], want["total_loss"],
                               rtol=1e-4)
    model = RetinaNet(backbone="resnet_50_dense", num_classes=CLASSES,
                      dtype=torch.float32)
    model.load_state_dict(params_from_flax(flat))
    np.testing.assert_allclose(
        l2_regularization(model.named_parameters(), "resnet_50_dense",
                          1e-4).item(), reg, rtol=1e-6)


def test_grad_accum_duplicated_batch_matches_plain(jax_run, port_run):
    """grad_accum=2 on the batch stacked twice lands on the parameters of
    a plain step on the batch: the two micro-gradients are identical and
    their mean is the plain gradient (fp32 ≤1e-6)."""
    flat, batch, _, _, _ = jax_run
    s1, m1 = port_run
    dup = tuple(np.concatenate([a, a]) for a in batch)
    cfg = _port_config(grad_accum=2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               batch_size=2 * BATCH))
    model = RetinaNet.from_config(cfg.model, 9, CLASSES)
    s2 = create_train_state(model, cfg, params_from_flax(flat))
    s2, m2 = make_train_step(model, build_levels(), cfg)(
        s2, *map(torch.from_numpy, dup))
    np.testing.assert_allclose(float(m2["total_loss"]), m1["total_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), m1["grad_norm"],
                               rtol=1e-5)
    for k, v in s1.params.items():
        np.testing.assert_allclose(s2.params[k].detach().numpy(),
                                   v.detach().numpy(), atol=1e-6)
    assert int(m2["num_fg"]) == 2 * int(m1["num_fg"])
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, build_levels(), cfg)(
            s2, *(torch.from_numpy(a[:3]) for a in dup))


def test_remat_matches_no_remat(jax_run, port_run, monkeypatch):
    """``ModelConfig.remat`` reaches the backbone through ``from_config``,
    runs each of the 16 blocks under ``checkpoint`` when training, and
    changes no number: the losses, every gradient (the momentum trace
    after one step from zero) and every updated parameter equal those of
    ``remat=False`` to ``tests/test_train.py::test_remat_matches_no_remat``'s
    bounds (loss 1e-6 relative, parameters 1e-6 absolute)."""
    from retinanet_tpu_torch.models import resnet

    flat, batch, _, _, _ = jax_run
    s0, m0 = port_run
    calls, real = [], resnet.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(type(fn).__name__)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(resnet, "checkpoint", counted)
    assert RetinaNet.from_config(_port_config(remat=True).model, 9,
                                 CLASSES).backbone_net.remat
    s1, m1 = _port_step(flat, batch, remat=True)
    assert calls == ["ResNetBottleneck"] * 16
    for key in ("total_loss", "class_loss", "regr_loss", "grad_norm"):
        np.testing.assert_allclose(m1[key], m0[key], rtol=1e-6, err_msg=key)
    assert set(s1.params) == set(s0.params)
    for name, g0, g1 in zip(s0.params, s0.opt_state["trace"],
                            s1.opt_state["trace"]):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(s1.params[name].detach().numpy(),
                                   s0.params[name].detach().numpy(),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("optimizer,clip", [
    ("momentum", None), ("momentum", 0.5), ("rmsprop", None),
    ("adam", None), ("adam", 2.0)])
def test_optimizer_matches_optax(optimizer, clip):
    """Three updates on a toy tree of two tensors with changing gradients:
    the port's update equals optax's to 1e-6 relative (float32)."""
    rng = np.random.RandomState(3)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    cfg = tcfg.TrainConfig(optimizer=optimizer, grad_clip_norm=clip,
                           schedule="warmup_cosine", warmup_steps=2,
                           schedule_steps=10)
    jcfg = JaxConfig().train.__class__(**dataclasses.asdict(cfg))
    tx = jax_optimizer(jcfg)
    jstate = tx.init([jnp.asarray(p) for p in params])
    port = build_optimizer(cfg)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = port.init(tparams)
    jparams = [jnp.asarray(p) for p in params]
    for _ in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        got = port.update([torch.from_numpy(g) for g in grads], tstate)
        for u, w in zip(got, updates):
            np.testing.assert_allclose(u.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine",
                                      "cyclical"])
def test_schedule_matches_optax(schedule):
    cfg = tcfg.TrainConfig(schedule=schedule, warmup_steps=5,
                           schedule_steps=20)
    want = jax_schedule(JaxConfig().train.__class__(**dataclasses.asdict(
        cfg)))
    got = build_schedule(cfg)
    for step in (0, 1, 3, 5, 9, 10, 11, 19, 20, 25):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{schedule}@{step}")


def test_int8_refused_and_benchmark_needs_card():
    cfg = _port_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, quantize="int8"))
    with pytest.raises(ValueError, match="serving-only"):
        make_train_step(None, build_levels(), cfg)
    with pytest.raises(RuntimeError, match="card"):
        benchmark_train(_port_config(), device="cpu")
