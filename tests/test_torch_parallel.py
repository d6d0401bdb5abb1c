"""The port's data parallelism (``retinanet_tpu_torch.parallel``) against
the JAX package's on the CPU: two gloo ranks (``torch_ranks``, one
``python -c`` worker each, started once for the file while JAX computes
its side) give the dataset partition and batch slices of JAX's
``parallel/distributed.py``, ``detection_loss`` and its gradient through
``global_sum`` equal to JAX's on the global batch, and a two-rank train
step (MobileNetV2, fp32, 64 px, global batch 8, weight decay and an active
gradient clip) equal to JAX's single-device ``make_train_step`` and its
``make_shard_map_train_step`` on the 8-device CPU mesh at the JAX test's
bounds (``tests/test_parallel.py``), its parameters bitwise equal across
the ranks.  In process: the backend rule, data-parallel ``Detector``
serving and the refusals that remain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.config import AssignConfig as JaxAssignConfig
from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.config import DataConfig as JaxDataConfig
from retinanet_tpu.config import LossConfig as JaxLossConfig
from retinanet_tpu.config import ModelConfig as JaxModelConfig
from retinanet_tpu.config import TrainConfig as JaxTrainConfig
from retinanet_tpu.data.loaders.shapes import Shapes as JaxShapes
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu.ops import losses as jax_losses
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.parallel import distributed as jax_distributed
from retinanet_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from retinanet_tpu.parallel.shard_map_step import make_shard_map_train_step
from retinanet_tpu.train import TrainState as JaxTrainState
from retinanet_tpu.train import build_optimizer as jax_optimizer
from retinanet_tpu.train import make_train_step as jax_step
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch import evaluate
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import init_params, params_from_flax
from retinanet_tpu_torch.infer import Detector
from retinanet_tpu_torch.parallel import distributed
from retinanet_tpu_torch.train import Trainer, refuse_distributed

from torch_parity import random_flat_params, to_flax
from torch_ranks import finish_ranks, start_ranks

torch.set_num_threads(2)

# The JAX test's step (tests/test_parallel.py), with an active clip.
SIZE, BATCH, BOXES, CLASSES, CLIP = 64, 8, 8, 3, 1.0
CLASS_LOSSES = ("bce", "focal", "dice", "jaccard", "fixed_iou",
                "balanced_bce")

_WORKER = r"""
import os
import sys

import numpy as np
import torch

from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.ops.losses import detection_loss
from retinanet_tpu_torch.parallel import distributed
from retinanet_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)
inputs, out, clip = sys.argv[1:4]
assert distributed.initialize("cpu") == "gloo"
rank, world = distributed.rank(), distributed.world_size()
assert (rank, world) == (int(os.environ["RANK"]), 2)
out = out.format(rank)
group = distributed.group()
data = np.load(inputs)
res = {}

# The dataset partition and the batch slice.
shard = distributed.shard_loader(Shapes(None, 10, (64, 64)), rank, world)
samples = list(shard)
res["shard_len"] = np.array([len(shard), len(samples)])
res["shard_boxes"] = np.concatenate([s["boxes"] for s in samples])
res["shard_image_sums"] = np.array([s["image"].sum(dtype=np.int64)
                                    for s in samples])
res["batch_slice"] = np.array(distributed.process_batch_slice(8))

# detection_loss on this rank's anchors, its sums over the ranks.
start, size = distributed.process_batch_slice(len(data["ct"]))
local = {k: torch.from_numpy(data[k][start:start + size])
         for k in ("ct", "cl", "rt", "rg", "tm")}
cl, rg = local["cl"].requires_grad_(), local["rg"].requires_grad_()
cfg = tcfg.LossConfig(class_losses=tuple(data["class_losses"]))
c, r = detection_loss(local["ct"], cl, local["rt"], rg, local["tm"], cfg,
                      group)
res["loss"] = torch.stack([c, r]).detach().numpy()
res["loss_grad_cl"], res["loss_grad_rg"] = (
    g.numpy() for g in torch.autograd.grad(c + r, (cl, rg)))

# One train step on this rank's slice of the global batch.
config = tcfg.Config(
    model=tcfg.ModelConfig(backbone="mobilenet_v2", num_classes=3,
                           dropout_rate=0.0, compute_dtype="float32"),
    data=tcfg.DataConfig(image_size=64, batch_size=8),
    assign=tcfg.AssignConfig(max_boxes=8),
    train=tcfg.TrainConfig(learning_rate=1e-2, grad_clip_norm=float(clip)))
model = RetinaNet.from_config(config.model, 9, 3)
state = create_train_state(model, config, params_from_flax(
    {k[2:]: data[k] for k in data.files if k.startswith("p/")}))
step = make_train_step(model, build_levels(config.anchors), config,
                       group=group)
start, size = distributed.process_batch_slice(config.data.batch_size)
batch = [torch.from_numpy(data[k][start:start + size])
         for k in ("images", "boxes", "ids", "mask")]
state, metrics = step(state, *batch, torch.Generator().manual_seed(1))
res.update({"m/" + k: v.numpy() for k, v in metrics.items()})
res.update({"p/" + k: v.detach().numpy() for k, v in state.params.items()})
np.savez(out, **res)
"""


def _step_batch():
    """The JAX test's batch: normal images with noise, one box each."""
    rng = np.random.RandomState(0)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    images += rng.randn(*images.shape).astype(np.float32) * 0.1
    boxes = np.zeros((BATCH, BOXES, 4), np.float32)
    boxes[:, 0] = [0.2, 0.2, 0.7, 0.7]
    ids = np.zeros((BATCH, BOXES), np.int32)
    mask = np.zeros((BATCH, BOXES), bool)
    mask[:, 0] = True
    return images, boxes, ids, mask


def _loss_inputs():
    """Global-batch loss inputs: 4 images × 300 anchors × 3 classes, a
    fifth of the anchors foreground, a tenth untrainable."""
    rng = np.random.RandomState(3)
    shape = (4, 300)
    fg = rng.rand(*shape) < 0.2
    ct = np.zeros(shape + (CLASSES,), np.float32)
    ct[fg, rng.randint(0, CLASSES, fg.sum())] = 1.0
    return {"ct": ct,
            "cl": (rng.randn(*shape, CLASSES) * 2).astype(np.float32),
            "rt": (rng.randn(*shape, 4) * 0.5).astype(np.float32),
            "rg": (rng.randn(*shape, 4) * 0.5).astype(np.float32),
            "tm": rng.rand(*shape) > 0.1}


def _jax_config():
    return JaxConfig(
        model=JaxModelConfig(backbone="mobilenet_v2", num_classes=CLASSES,
                             dropout_rate=0.0, compute_dtype="float32"),
        data=JaxDataConfig(image_size=SIZE, batch_size=BATCH),
        assign=JaxAssignConfig(max_boxes=BOXES),
        train=JaxTrainConfig(learning_rate=1e-2, grad_clip_norm=CLIP))


def _flat_params(params):
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(params).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and JAX's, computed while the ranks run."""
    root = tmp_path_factory.mktemp("parallel")
    cfg = _jax_config()
    flat = random_flat_params(cfg.model, seed=0)
    batch = _step_batch()
    loss_in = _loss_inputs()
    np.savez(root / "inputs.npz", images=batch[0], boxes=batch[1],
             ids=batch[2], mask=batch[3], class_losses=np.array(CLASS_LOSSES),
             **loss_in, **{"p/" + k: v for k, v in flat.items()})
    procs = start_ranks(_WORKER, root / "inputs.npz", root / "rank{}.npz",
                        CLIP)
    try:
        levels = jax_levels(cfg.anchors)
        model = JaxRetinaNet.from_config(cfg.model, num_anchors=9)
        params = to_flax(flat)
        state = JaxTrainState(jnp.zeros((), jnp.int32), params,
                              jax_optimizer(cfg.train).init(params))
        rng = jax.random.PRNGKey(5)
        single = jax.jit(jax_step(model, levels, cfg))(
            state, *map(jnp.asarray, batch), rng)
        mesh = make_mesh()
        sharded = make_shard_map_train_step(model, levels, cfg, mesh)(
            jax.device_put(state, replicated(mesh)),
            *shard_batch(batch, mesh), jax.device_put(rng, replicated(mesh)))
        jcfg = JaxLossConfig(class_losses=CLASS_LOSSES)
        j = {k: jnp.asarray(v) for k, v in loss_in.items()}

        def total(cl, rg):
            c, r = jax_losses.detection_loss(j["ct"], cl, j["rt"], rg,
                                             j["tm"], jcfg)
            return c + r, (c, r)

        (_, loss), loss_grads = jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True)(j["cl"], j["rg"])
    finally:
        finish_ranks(procs)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    return {"ranks": ranks, "jax_steps": {
        name: (_flat_params(s.params), {k: np.asarray(v)
                                        for k, v in m.items()})
        for name, (s, m) in (("single", single), ("shard_map", sharded))},
        "loss": (np.asarray(loss), [np.asarray(g) for g in loss_grads])}


def test_shard_loader_partitions_like_jax(run, monkeypatch):
    """Each rank's shard of a 10-image Shapes set is JAX's shard for that
    index (the same samples in the same order, lengths 5 and 5), and
    ``process_batch_slice(8)`` gives JAX's (start, size) at 2 processes."""
    for r, got in enumerate(run["ranks"]):
        want = list(jax_distributed.shard_loader(JaxShapes(None, 10, (64, 64)),
                                                 r, 2))
        assert got["shard_len"].tolist() == [len(want)] * 2 == [5, 5]
        np.testing.assert_array_equal(
            got["shard_boxes"], np.concatenate([s["boxes"] for s in want]))
        assert got["shard_image_sums"].tolist() == [
            int(s["image"].sum(dtype=np.int64)) for s in want]
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert tuple(got["batch_slice"]) == \
            jax_distributed.process_batch_slice(8) == (4 * r, 4)


def test_detection_loss_is_global_like_jax(run):
    """Every class loss and Huber through ``global_sum``: each rank's
    (class, regression) loss is JAX's on the global batch (fp32, ≤1e-5
    relative), and the gradients of each rank's own logits, put together,
    are JAX's gradient (≤1e-5 of the largest)."""
    loss, (g_cl, g_rg) = run["loss"]
    for got in run["ranks"]:
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    for name, want in (("loss_grad_cl", g_cl), ("loss_grad_rg", g_rg)):
        got = np.concatenate([r[name] for r in run["ranks"]])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("reference", ["single", "shard_map"])
def test_two_rank_step_matches_jax(run, reference):
    """The JAX test's bounds: total_loss ≤1e-5 and grad_norm ≤1e-4
    relative, every parameter after the clipped step within 2e-5."""
    want_params, want = run["jax_steps"][reference]
    want_params = params_from_flax(want_params)
    for got in run["ranks"]:
        np.testing.assert_allclose(got["m/total_loss"], want["total_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["m/grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        assert got["m/grad_norm"] > CLIP  # the clip acted
        for name, p in want_params.items():
            np.testing.assert_allclose(got["p/" + name], p.numpy(),
                                       rtol=0, atol=2e-5, err_msg=name)


def test_two_rank_metrics_are_global(run):
    """The diagnostics are the global batch's, as JAX's single-device
    step has them: num_fg exact; each histogram's total exact and at most
    one entry in another bin (a probability on a bin edge falls either
    side between two fp32 programs: measured, one of 19200); the IoU
    ratios and the losses ≤1e-4."""
    _, want = run["jax_steps"]["single"]
    for got in run["ranks"]:
        assert int(got["m/num_fg"]) == int(want["num_fg"]) > 0
        for key in ("prob_fg_hist", "prob_bg_hist"):
            assert got["m/" + key].sum() == want[key].sum() > 0, key
            assert np.abs(got["m/" + key] - want[key]).sum() <= 2, key
        for key in ("class_iou", "regr_iou", "class_loss", "regr_loss",
                    "regularization_loss"):
            np.testing.assert_allclose(got["m/" + key], want[key],
                                       rtol=1e-4, atol=1e-7, err_msg=key)


def test_two_rank_parameters_bitwise_equal(run):
    a, b = run["ranks"]
    names = [k for k in a if k.startswith(("p/", "m/"))]
    assert len(names) > 200
    for name in names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# -- in process ----------------------------------------------------------------


@pytest.mark.parametrize("device,local_rank,local_world,cards,want", [
    ("cpu", 0, 2, 0, "gloo"),
    ("cuda", 1, 2, 2, "nccl"),     # torchrun on two cards
    ("cuda", 0, 4, 2, "gloo"),     # more ranks than cards
    ("cuda:0", 1, 2, 2, "gloo"),   # two ranks named onto one card
    ("cuda:0", 0, 2, 4, "gloo"),   # ... on a host of four cards
    ("cuda:0", 0, 1, 1, "nccl"),   # one rank, one card
])
def test_backend_rule(monkeypatch, device, local_rank, local_world, cards,
                      want):
    """NCCL when every rank has a card of its own, gloo otherwise."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got, reason = distributed.backend_for(device, local_world)
    assert got == want, reason


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0", "cuda:1"])
def test_backend_rule_agrees_across_ranks(monkeypatch, device):
    """Every local rank given one ``--device`` picks the same backend,
    whatever the host's ranks and cards: a group of mixed backends never
    starts."""
    for local_world in (1, 2, 4, 8):
        for cards in (0, 1, 2, 4, 8):
            monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
            picked = set()
            for local_rank in range(local_world):
                monkeypatch.setenv("LOCAL_RANK", str(local_rank))
                picked.add(distributed.backend_for(device, local_world)[0])
            assert len(picked) == 1, (local_world, cards, picked)


def test_one_process_helpers(monkeypatch):
    """At one process: no group, rank 0 of 1, the lead; the whole batch;
    the loader itself; ``[obj]``; ``global_sum`` the identity; ``cuda``
    the card of ``LOCAL_RANK``, round the host's cards."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize("cpu") is None
    assert (distributed.rank(), distributed.world_size(),
            distributed.is_lead(), distributed.group()) == (0, 1, True, None)
    assert distributed.process_batch_slice(8) == (0, 8)
    loader = Shapes(None, 3, (64, 64))
    assert distributed.shard_loader(loader, 0, 1) is loader
    with pytest.raises(ValueError, match="out of range"):
        distributed.shard_loader(loader, 2, 2)
    obj = {"records": [(3, np.zeros(2))]}
    assert distributed.allgather_pyobjs(obj)[0] is obj
    x = torch.ones(3, requires_grad=True)
    assert distributed.global_sum(x) is x
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    assert distributed.rank_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)


def _detector_config(batch):
    config = tcfg.Config(model=tcfg.ModelConfig(
        backbone="mobilenet_v2", num_classes=CLASSES, dropout_rate=0.0,
        compute_dtype="float32"))
    return config.replace(
        data=dataclasses.replace(config.data, image_size=SIZE,
                                 batch_size=batch),
        nms=dataclasses.replace(config.nms, score_threshold=0.005))


def test_data_parallel_detector_matches_one_device():
    """``Detector(devices=["cpu", "cpu"])``: two replicas, each serving
    half the batch, give one device's detections (the JAX test's bounds:
    the same count per image, scores 1e-5, boxes 1e-4, classes exact), in
    batch order; a batch the devices do not divide raises."""
    config = _detector_config(4)
    params = init_params(config, torch.Generator().manual_seed(0), CLASSES)
    names = ["square", "triangle", "circle"]
    one = Detector(config, params, names, "cpu")
    two = Detector(config, params, names, devices=["cpu", "cpu"])
    assert two.devices == [torch.device("cpu")] * 2
    images = np.random.RandomState(1).randn(4, SIZE, SIZE, 3).astype(
        np.float32)
    a, b = one(images), two(images)
    total = 0
    for i in range(4):
        va, vb = a.valid[i], b.valid[i]
        assert int(va.sum()) == int(vb.sum()), i
        total += int(va.sum())
        for field, tol in (("scores", 1e-5), ("boxes", 1e-4),
                           ("class_ids", 0)):
            np.testing.assert_allclose(getattr(a, field)[i][va].numpy(),
                                       getattr(b, field)[i][vb].numpy(),
                                       atol=tol, err_msg=f"{i} {field}")
    assert total > 0
    with pytest.raises(ValueError, match="divisible"):
        two(images[:3])
    with pytest.raises(ValueError, match="divisible"):
        Detector(_detector_config(3), params, names,
                 devices=["cpu", "cpu"])


@pytest.mark.parametrize("case", ["spatial", "devices_in_one_process",
                                  "evaluate_spatial"])
def test_remaining_refusals(case, tmp_path):
    """What still raises: ``--spatial`` (A.7's second part) and one
    process over several devices (``torchrun`` gives a rank each)."""
    if case == "evaluate_spatial":
        with pytest.raises(SystemExit, match="A.7, second part"):
            evaluate.main(["--dataset", "shapes", "unused", "2", "64",
                           "--from-export", "unused.npz", "--spatial", "2"])
        return
    parallel = (tcfg.ParallelConfig(spatial=2) if case == "spatial"
                else tcfg.ParallelConfig(num_devices=2))
    config = tcfg.Config(parallel=parallel)
    match = ("A.7, second part" if case == "spatial"
             else "torchrun --nproc-per-node N")
    with pytest.raises(NotImplementedError, match=match):
        refuse_distributed(config)
    with pytest.raises(NotImplementedError, match=match):
        Trainer(config.replace(train=dataclasses.replace(
            config.train, experiment=str(tmp_path))),
            loader=Shapes(None, 2, (SIZE, SIZE)), device="cpu")
