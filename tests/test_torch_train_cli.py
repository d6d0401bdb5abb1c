"""The port's training CLI and what surrounds it, on the CPU
(``--device cpu``): ``config_from_args`` against JAX's on the same flags,
``MetricsWriter``/``TBEventWriter`` against JAX's, and the chain
``train`` → ``export --experiment`` → ``evaluate --from-export``, whose
metrics equal ``evaluate --experiment``'s, with ``detect --experiment``;
the default backbone (ResNeXt-50) trains, and the runs the port does not
spread (``--spatial``, ``num_devices`` other than the number of ranks)
raise naming A.7.  The flagship at 64 px, 3 shapes classes."""

import dataclasses
import json
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinanet_tpu import config as jcfg
from retinanet_tpu.utils.summaries import MetricsWriter as JaxWriter
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch import detect, evaluate, export, train
from retinanet_tpu_torch.data.loaders.shapes import Shapes
from retinanet_tpu_torch.parallel import distributed
from retinanet_tpu_torch.train import CheckpointStore, Trainer
from retinanet_tpu_torch.utils.summaries import MetricsWriter

torch.set_num_threads(2)

SIZE = 64
NAMES = ["square", "triangle", "circle"]


def _port_config(experiment, **train_fields):
    return tcfg.Config(
        model=tcfg.ModelConfig(backbone="resnet_50_dense", num_classes=3,
                               dropout_rate=0.0, compute_dtype="float32"),
        data=tcfg.DataConfig(image_size=SIZE, batch_size=2, num_workers=2),
        assign=tcfg.AssignConfig(max_boxes=8),
        train=tcfg.TrainConfig(experiment=str(experiment), **train_fields))


def _records(experiment):
    with open(os.path.join(experiment, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


ARGV = ["--dataset", "shapes", "/tmp/s", "64", "320", "--experiment", "e",
        "--backbone", "resnet_50_dense", "--scale", "320", "--batch-size",
        "16", "--learning-rate", "1e-2", "--dropout", "0", "--seed", "42",
        "--log-every", "10", "--steps-per-epoch", "200", "--epochs", "3",
        "--fused-train", "--grad-clip-norm", "5", "--optimizer", "adam",
        "--workers", "3", "--augment-photometric", "--augment-scale-jitter",
        "0.2", "--buckets", "320x320", "320x224", "--class-loss", "focal",
        "--schedule", "warmup_cosine", "--warmup-steps", "10",
        "--schedule-steps", "400", "--grad-accum", "2", "--spatial", "2",
        "--init-backbone", "w.pt", "--profile", "3"]


@pytest.mark.parametrize("argv", [ARGV, ARGV[:7], ARGV[:7] + [
    "--pair-flip-batching"]], ids=["every-flag", "defaults", "pair-flip"])
def test_config_from_args_equals_jax(argv):
    got = tcfg.config_from_args(argv + ["--device", "cpu"])
    want = jcfg.config_from_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tcfg.parse_args(argv)[1] == "cuda"


def _events(path):
    """(payload with the wall time zeroed) of each TFRecord of a file."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        payload = data[pos + 12:pos + 12 + length]
        assert payload[0] == 0x09  # Event.wall_time, a double
        out.append(b"\x09" + bytes(8) + payload[9:])
        pos += 12 + length + 4
    return out


def test_metrics_writer_equals_jax(tmp_path):
    """The same records in metrics.jsonl (the wall time masked) and the
    same TensorBoard events (each record's wall time zeroed), from
    tensors on the port's side and numpy arrays on JAX's."""
    rng = np.random.RandomState(0)
    steps = []
    for step in (1, 10):
        hist = rng.randint(0, 50, 20).astype(np.float32)
        steps.append((step, {"total_loss": np.float32(rng.rand()),
                             "num_fg": np.int32(17 * step),
                             "prob_fg_hist": hist,
                             "prob_bg_hist": hist[::-1].copy(),
                             "images_per_sec": 3.25 * step}))
    png = b"\x89PNG fake"
    for name, writer, convert in (
            ("jax", JaxWriter, jnp.asarray),
            ("port", MetricsWriter, lambda v: torch.from_numpy(np.asarray(v)))):
        w = writer(str(tmp_path / name))
        for step, metrics in steps:
            w.write(step, {k: v if isinstance(v, float) else convert(v)
                           for k, v in metrics.items()})
        w.write(10, {"mAP": 0.5}, prefix="eval")
        w.add_image_png("boxes/0_true", png, 4, 5, 10)
        w.close()
    records, events = [], []
    for name in ("jax", "port"):
        rec = _records(str(tmp_path / name))
        for r in rec:
            r.pop("time")
        records.append(rec)
        (tb,) = [p for p in os.listdir(tmp_path / name)
                 if p.startswith("events.out.tfevents")]
        events.append(_events(str(tmp_path / name / tb)))
    assert records[0] == records[1] and len(records[0]) == 3
    assert events[0] == events[1] and len(events[0]) == 9


def _fp32_parse(real):
    """The training CLI's parse with fp32 compute: the CPU's bf16 conv
    weight gradient is unreliable at 64 px (ROADMAP C.10)."""
    def parse(argv):
        config, device = real(argv)
        return config.replace(model=dataclasses.replace(
            config.model, compute_dtype="float32")), device
    return parse


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``train`` for one step into an experiment, then ``export`` of it."""
    root = tmp_path_factory.mktemp("cli")
    dataset = ["shapes", str(root / "s"), "4", str(SIZE)]
    experiment, artifact = str(root / "exp"), str(root / "m.npz")
    real = train.parse_args
    train.parse_args = _fp32_parse(real)
    try:
        state = train.main(["--dataset", *dataset, "--experiment",
                            experiment, "--backbone", "resnet_50_dense",
                            "--scale", str(SIZE), "--batch-size", "2",
                            "--epochs", "1", "--steps-per-epoch", "1",
                            "--dropout", "0", "--device", "cpu"])
    finally:
        train.parse_args = real
    export.main(["--experiment", experiment, "--backbone",
                 "resnet_50_dense", "--scale", str(SIZE), "--dataset",
                 *dataset, "--out", artifact, "--device", "cpu"])
    yield dict(dataset=dataset, experiment=experiment, artifact=artifact,
               state=state, root=root)
    shutil.rmtree(root)  # a checkpoint holds ~300 MB, the export ~150


def test_train_cli_trains_and_saves(cli_run):
    assert cli_run["state"].step == 1
    store = CheckpointStore(cli_run["experiment"])
    assert store.checkpoint_steps() == [1]
    assert [r["step"] for r in _records(cli_run["experiment"])] == [1]


def test_evaluate_from_export_equals_from_experiment(cli_run, capsys):
    """The export of the checkpoint evaluates to the metrics of the
    checkpoint itself, printed the same."""
    base = ["--dataset", *cli_run["dataset"], "--batch-size", "2",
            "--device", "cpu", "--decode-threshold", "0.05"]
    printed = []
    for extra in (["--experiment", cli_run["experiment"], "--backbone",
                   "resnet_50_dense", "--scale", str(SIZE)],
                  ["--from-export", cli_run["artifact"]],
                  ["--experiment", cli_run["experiment"], "--backbone",
                   "resnet_50_dense", "--scale", str(SIZE), "--step", "1"]):
        evaluate.main(base + extra)
        printed.append(capsys.readouterr().out.strip().splitlines())
    assert len(printed[0]) == 1
    assert printed[0] == printed[1] == printed[2]


def test_detect_cli_serves_the_experiment(cli_run):
    from PIL import Image

    paths = []
    for i in range(2):
        image = next(iter(Shapes(None, 1, (SIZE, SIZE), seed=i)))["image"]
        paths.append(str(cli_run["root"] / f"d{i}.png"))
        Image.fromarray(image).save(paths[-1])
    records = detect.main([*paths, "--experiment", cli_run["experiment"],
                           "--backbone", "resnet_50_dense", "--scale",
                           str(SIZE), "--class-names", ",".join(NAMES),
                           "--step", "1", "--score-threshold", "0.0",
                           "--device", "cpu"])
    assert {r["image"] for r in records} == set(paths)
    assert {r["class"] for r in records} <= set(NAMES)


def test_default_backbone_raises_naming_a6(tmp_path):
    """The default ``--backbone`` (``resnet_50``, ResNeXt-50) trains: two
    steps at 64 px on the CPU (fp32 compute, as ``cli_run``), finite
    losses, a checkpoint at step 2."""
    real = train.parse_args
    train.parse_args = _fp32_parse(real)
    try:
        state = train.main(["--dataset", "shapes", str(tmp_path / "s"), "4",
                            str(SIZE), "--experiment", str(tmp_path / "e"),
                            "--scale", str(SIZE), "--batch-size", "2",
                            "--epochs", "1", "--steps-per-epoch", "2",
                            "--log-every", "1", "--device", "cpu"])
    finally:
        train.parse_args = real
    assert state.step == 2
    records = _records(str(tmp_path / "e"))
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in records)
    assert CheckpointStore(str(tmp_path / "e")).checkpoint_steps() == [2]


@pytest.mark.parametrize("case", ["spatial", "num_devices", "world_size",
                                  "evaluate_data_parallel",
                                  "evaluate_spatial"])
def test_distributed_runs_raise_naming_a7(case, tmp_path, monkeypatch):
    """``--spatial`` (with ``--data-parallel`` too, which A.7's first part
    ported) and a ``num_devices`` other than the ranks, more devices
    than processes or fewer, raise naming A.7 (and ``torchrun``)."""
    if case.startswith("evaluate"):
        flag = (["--data-parallel", "--spatial", "2"]
                if case.endswith("parallel") else ["--spatial", "2"])
        with pytest.raises(SystemExit, match=r"ROADMAP A\.7"):
            evaluate.main(["--dataset", "shapes", "unused", "2", "64",
                           "--experiment", str(tmp_path), *flag])
        return
    config = _port_config(tmp_path)
    if case == "spatial":
        config = tcfg.config_from_args(
            ["--dataset", "shapes", "unused", "2", "64", "--experiment",
             str(tmp_path), "--backbone", "resnet_50_dense", "--spatial",
             "2"])
    elif case == "num_devices":
        config = config.replace(parallel=tcfg.ParallelConfig(num_devices=2))
    else:  # two ranks, one device named
        config = config.replace(parallel=tcfg.ParallelConfig(num_devices=1))
        monkeypatch.setattr(distributed, "world_size", lambda: 2)
    match = r"ROADMAP A\.7" + ("" if case == "spatial"
                               else r".*torchrun --nproc-per-node N")
    with pytest.raises(NotImplementedError, match=match):
        Trainer(config, loader=Shapes(None, 2, (SIZE, SIZE)), device="cpu")


def test_grad_accum_must_divide_the_batch(tmp_path):
    """The JAX Trainer's guard, before anything is built."""
    with pytest.raises(ValueError, match="grad_accum=3"):
        Trainer(_port_config(tmp_path, grad_accum=3),
                loader=Shapes(None, 2, (SIZE, SIZE)), device="cpu")


def test_benchmark_train_pipeline_needs_card():
    """As ``benchmark_train``: a time taken on the CPU is not the card's."""
    with pytest.raises(RuntimeError, match="card"):
        train.benchmark_train_pipeline(_port_config("unused"),
                                       device="cpu")
