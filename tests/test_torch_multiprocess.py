"""Multi-process runs of the port on the CPU, two gloo ranks
(``torch_ranks``; the workers start once for the file, while JAX computes
its side): a step with ``grad_accum = 2`` against JAX's single-device step
on the global batch permuted so that its micro-batches are the ranks'
(MobileNetV2, fp32, 64 px, weight decay on, no clip), ``Trainer.fit``
under two ranks with buckets and a resume, and ``evaluate.main`` under two
ranks against one process.  ``test_torch_parallel.py`` holds the helpers,
the loss and the clipped step."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from retinanet_tpu.config import AssignConfig as JaxAssignConfig
from retinanet_tpu.config import Config as JaxConfig
from retinanet_tpu.config import DataConfig as JaxDataConfig
from retinanet_tpu.config import ModelConfig as JaxModelConfig
from retinanet_tpu.config import TrainConfig as JaxTrainConfig
from retinanet_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from retinanet_tpu.ops.anchors import build_levels as jax_levels
from retinanet_tpu.train import TrainState as JaxTrainState
from retinanet_tpu.train import build_optimizer as jax_optimizer
from retinanet_tpu.train import make_train_step as jax_step
from retinanet_tpu_torch import evaluate
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.train import CheckpointStore

from torch_parity import random_flat_params, to_flax
from torch_ranks import finish_ranks, start_ranks

torch.set_num_threads(2)

SIZE, BATCH, BOXES, CLASSES, ACCUM = 64, 8, 8, 3, 2
# Global-batch order of the micro-batches that two ranks of 4 images each
# step on with grad_accum = 2: micro-batch j is both ranks' j-th chunk.
PERMUTED = [0, 1, 4, 5, 2, 3, 6, 7]
FIT_STEPS = 4  # two invocations of 2 steps, the second resuming

_WORKER = r"""
import contextlib
import json
import logging
import sys

import numpy as np
import torch

from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch import evaluate, train
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.export import params_from_flax
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.parallel import distributed

torch.set_num_threads(2)
root = sys.argv[1]
assert distributed.initialize("cpu") == "gloo"
rank, world = distributed.rank(), distributed.world_size()
data = np.load(f"{root}/inputs.npz")
res = {}

# A step with grad_accum = 2 on this rank's slice of the global batch.
config = tcfg.Config(
    model=tcfg.ModelConfig(backbone="mobilenet_v2", num_classes=3,
                           dropout_rate=0.0, compute_dtype="float32"),
    data=tcfg.DataConfig(image_size=64, batch_size=8),
    assign=tcfg.AssignConfig(max_boxes=8),
    train=tcfg.TrainConfig(learning_rate=1e-2, grad_accum=2))
model = RetinaNet.from_config(config.model, 9, 3)
state = train.create_train_state(model, config, params_from_flax(
    {k[2:]: data[k] for k in data.files if k.startswith("p/")}))
step = train.make_train_step(model, build_levels(config.anchors), config,
                             group=distributed.group())
start, size = distributed.process_batch_slice(8)
batch = [torch.from_numpy(data[k][start:start + size])
         for k in ("images", "boxes", "ids", "mask")]
state, metrics = step(state, *batch, torch.Generator().manual_seed(1))
res.update({"m/" + k: v.numpy() for k, v in metrics.items()})
res.update({"p/" + k: v.detach().numpy() for k, v in state.params.items()})

# Trainer.fit under two ranks, buckets on, dropout on, then a resume.
messages = []
handler = logging.Handler()
handler.emit = lambda record: messages.append(record.getMessage())
logging.getLogger(train.__name__).addHandler(handler)
logging.getLogger(train.__name__).setLevel(logging.INFO)
fit_config = tcfg.Config(
    model=tcfg.ModelConfig(backbone="mobilenet_v2", num_classes=3,
                           compute_dtype="float32"),
    data=tcfg.DataConfig(dataset=("shapes", "unused", "16", "64"),
                         image_size=64, batch_size=4, shuffle_buffer=1,
                         num_workers=2, augment_flip=False,
                         buckets=((64, 64), (64, 32))),
    assign=tcfg.AssignConfig(max_boxes=8),
    train=tcfg.TrainConfig(experiment=f"{root}/exp", epochs=1,
                           steps_per_epoch=2, checkpoint_every=1000,
                           log_every=1, learning_rate=1e-3))
canvases = []
for _ in range(2):
    trainer = train.Trainer(fit_config, loader=Shapes(None, 16, (64, 64)),
                            device="cpu")
    assert trainer.pipeline.config.batch_size == 2
    assert trainer.pipeline.scheduled_canvases
    assert trainer.is_lead == (rank == 0)
    stream, seen = trainer._device_batches, []

    def recorded(epoch, stream=stream, seen=seen):
        with contextlib.closing(stream(epoch)) as batches:
            for device_batch, batch in batches:
                seen.append(batch.images.shape[1:3])
                yield device_batch, batch

    trainer._device_batches = recorded
    fit_state = trainer.fit()
    canvases += seen[:2]  # the loop also takes the batch after its last
res["fit_step"] = np.array(fit_state.step)
res["canvases"] = np.array(canvases)
res["restored"] = np.array(["restored checkpoint from step 2" in m
                            for m in messages]).sum()
res.update({"fit/" + k: v.detach().numpy()
            for k, v in fit_state.params.items()})

# evaluate.main: this rank's shard, every rank the whole set's metrics.
base = ["--dataset", "shapes", "unused", "16", "64", "--experiment",
        f"{root}/exp", "--backbone", "mobilenet_v2", "--scale", "64",
        "--batch-size", "4", "--device", "cpu", "--decode-threshold", "0.005"]
res["eval"] = np.array(json.dumps(evaluate.main(base), sort_keys=True))
res["eval_dp"] = np.array(json.dumps(evaluate.main(base + ["--data-parallel"]),
                                     sort_keys=True))
np.savez(f"{root}/rank{rank}.npz", **res)
"""


def _batch():
    """Normal images, 3 boxes of random classes per image (sides 0.35-0.7
    of the canvas), so that the micro-batches' statistics differ."""
    rng = np.random.RandomState(7)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    boxes = np.zeros((BATCH, BOXES, 4), np.float32)
    corner = rng.rand(BATCH, 3, 2) * 0.3
    boxes[:, :3] = np.concatenate(
        [corner, corner + 0.35 + rng.rand(BATCH, 3, 2) * 0.35], -1)
    ids = np.zeros((BATCH, BOXES), np.int32)
    ids[:, :3] = rng.randint(0, CLASSES, (BATCH, 3))
    mask = np.zeros((BATCH, BOXES), bool)
    mask[:, :3] = True
    return images, boxes, ids, mask


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, JAX's accumulated step on the permuted batch
    (computed while the ranks run), and one process's evaluation of the
    ranks' checkpoint."""
    root = tmp_path_factory.mktemp("multiprocess")
    cfg = JaxConfig(
        model=JaxModelConfig(backbone="mobilenet_v2", num_classes=CLASSES,
                             dropout_rate=0.0, compute_dtype="float32"),
        data=JaxDataConfig(image_size=SIZE, batch_size=BATCH),
        assign=JaxAssignConfig(max_boxes=BOXES),
        train=JaxTrainConfig(learning_rate=1e-2, grad_accum=ACCUM))
    flat = random_flat_params(cfg.model, seed=1)
    batch = _batch()
    np.savez(root / "inputs.npz", images=batch[0], boxes=batch[1],
             ids=batch[2], mask=batch[3],
             **{"p/" + k: v for k, v in flat.items()})
    procs = start_ranks(_WORKER, root)
    try:
        params = to_flax(flat)
        state = JaxTrainState(jnp.zeros((), jnp.int32), params,
                              jax_optimizer(cfg.train).init(params))
        model = JaxRetinaNet.from_config(cfg.model, num_anchors=9)
        state, metrics = jax.jit(jax_step(model, jax_levels(cfg.anchors), cfg,
                                          with_metrics=False))(
            state, *(jnp.asarray(a[PERMUTED]) for a in batch),
            jax.random.PRNGKey(5))
        want = (params_from_flax({"/".join(k): np.asarray(v) for k, v in
                                  traverse_util.flatten_dict(
                                      state.params).items()}),
                {k: np.asarray(v) for k, v in metrics.items()})
    finally:
        finish_ranks(procs)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    base = ["--dataset", "shapes", "unused", "16", "64", "--experiment",
            str(root / "exp"), "--backbone", "mobilenet_v2", "--scale", "64",
            "--batch-size", "4", "--device", "cpu", "--decode-threshold",
            "0.005"]
    one = json.dumps(evaluate.main(base), sort_keys=True)
    return {"root": root, "ranks": ranks, "jax": want, "one_process": one}


def test_accumulated_step_matches_jax_on_the_permuted_batch(run):
    """grad_accum = 2 on two ranks is JAX's single-device step with
    grad_accum = 2 on the global batch in ``PERMUTED`` order, at the JAX
    test's bounds (total_loss 1e-5, grad_norm 1e-4, parameters 2e-5)."""
    want_params, want = run["jax"]
    for got in run["ranks"]:
        np.testing.assert_allclose(got["m/total_loss"], want["total_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["m/grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        for name, p in want_params.items():
            np.testing.assert_allclose(got["p/" + name], p.numpy(), rtol=0,
                                       atol=2e-5, err_msg=name)
    a, b = run["ranks"]
    for name in (k for k in a if k.startswith(("p/", "m/"))):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_two_rank_fit_shares_canvases_and_parameters(run):
    """``Trainer.fit`` with buckets and dropout 0.2 (each rank its own
    masks): both ranks step on the same canvas at every step, end at step
    4, and hold bitwise equal parameters."""
    a, b = run["ranks"]
    assert int(a["fit_step"]) == int(b["fit_step"]) == FIT_STEPS
    assert len(a["canvases"]) == FIT_STEPS
    np.testing.assert_array_equal(a["canvases"], b["canvases"])
    names = [k for k in a if k.startswith("fit/")]
    assert len(names) > 200
    for name in names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_two_rank_fit_writes_on_the_lead_alone(run):
    """One metrics record a logged step (the lead's), whole checkpoints at
    steps 2 and 4 holding the ranks' parameters, and the restore of step
    2 logged on both ranks."""
    exp = run["root"] / "exp"
    records = [json.loads(line) for line in
               (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == list(range(1, FIT_STEPS + 1))
    assert len(list(exp.glob("events.out.tfevents.*"))) <= 2  # one a run
    store = CheckpointStore(str(exp))
    assert store.checkpoint_steps() == [2, FIT_STEPS]
    assert not [p for p in (exp / "checkpoints").iterdir()
                if "tmp" in p.name]
    saved = torch.load(exp / "checkpoints" / f"step_{FIT_STEPS}" /
                       "params.pt", weights_only=True)["params"]
    for name, value in saved.items():
        np.testing.assert_array_equal(value.numpy(),
                                      run["ranks"][0]["fit/" + name])
    assert [int(r["restored"]) for r in run["ranks"]] == [1, 1]


def test_two_rank_evaluate_equals_one_process(run):
    """Every rank prints the metrics of one process over the whole set,
    with ``--data-parallel`` too (the rank's one device)."""
    for got in run["ranks"]:
        assert str(got["eval"]) == str(got["eval_dp"]) == run["one_process"]
    assert json.loads(run["one_process"])["AR@100"] > 0
