"""The port's serving CLIs on the CPU (``--device cpu``), on a 64-px export
of seeded weights: ``evaluate --from-export`` prints, as one strict-JSON
line, the metrics that ``evaluate_model`` returns for the same detector
(with buckets, per-class AP, a detection dump and the VOC protocol), and
exits naming the order when the export's classes are reversed; ``detect``
loads its batch bitwise as JAX's ``_load_batch`` does and dumps what
``Detector.detect`` gives on the same batch; both CLIs serve an
experiment's checkpoints (``--experiment``, ``--step``,
``--average-checkpoints``) as they serve an export of the same weights;
the flags whose port has not landed raise, naming their ROADMAP item."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from retinanet_tpu.detect import _load_batch as jax_load_batch
from retinanet_tpu_torch import detect, evaluate
from retinanet_tpu_torch.config import Config, ModelConfig, parse_buckets
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.eval_coco import evaluate_model
from retinanet_tpu_torch.export import (export_model, init_params,
                                        load_exported_detector)
from retinanet_tpu_torch.train import CheckpointStore, TrainState

torch.set_num_threads(2)

NAMES = ["square", "triangle", "circle"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Exports of one set of He-scaled weights (numpy seeded; the π prior
    would put every score at one value) at 64 px: with the shapes classes
    in order, and reversed; and an experiment holding the same weights as
    the checkpoints of steps 1, 2 and 3."""
    config = Config(model=ModelConfig(backbone="resnet_50_dense",
                                      num_classes=3))
    rng = np.random.RandomState(0)
    state = {}
    for key, t in init_params(config, torch.Generator().manual_seed(0),
                              3).items():
        if key.endswith("kernel"):
            v = rng.randn(*t.shape) * np.sqrt(2.0 / np.prod(t.shape[1:]))
        else:
            v = float(key.endswith("gamma")) + 0.1 * rng.randn(*t.shape)
        state[key] = torch.from_numpy(np.asarray(v, np.float32))
    root = tmp_path_factory.mktemp("exports")
    paths = []
    for names, name in ((NAMES, "model"), (NAMES[::-1], "reversed")):
        path = str(root / f"{name}.npz")
        export_model(state, names, "resnet_50_dense", 64, path)
        paths.append(path)
    experiment = str(root / "experiment")
    store = CheckpointStore(experiment)
    for step in (1, 2, 3):
        store.save(TrainState(step, state, {"count": 0}))
    store.wait_for_checkpoints()
    yield paths + [experiment]
    shutil.rmtree(root)  # three checkpoints and two exports, ~750 MB


@pytest.mark.parametrize("protocol", ["coco", "voc"])
def test_evaluate_cli_prints_evaluate_model_metrics(artifacts, tmp_path,
                                                    capsys, protocol):
    dataset = ["shapes", str(tmp_path / "shapes"), "6", "64"]
    dump = str(tmp_path / "dets.json")
    got = evaluate.main(
        ["--dataset", *dataset, "--from-export", artifacts[0],
         "--batch-size", "4", "--device", "cpu", "--decode-threshold", "0.1",
         "--buckets", "64x64", "48x64", "--per-class", "--protocol",
         protocol, "--max-images", "5", "--dump-detections", dump])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    assert json.loads(printed[0]) == evaluate.strict_json(got)

    config = Config()
    config = config.replace(
        data=dataclasses.replace(config.data, image_size=64, batch_size=4,
                                 buckets=parse_buckets(["64x64", "48x64"])),
        nms=dataclasses.replace(config.nms, score_threshold=0.1))
    detector = load_exported_detector(artifacts[0], config, device="cpu")
    assert detector.config.model.backbone == "resnet_50_dense"
    records = []
    want = evaluate_model(
        detector, Inferred(dataset[0], dataset[1:], include_crowds=True),
        config, max_images=5, protocol=protocol, per_class=True,
        detections_sink=lambda gt, det: records.append(len(det["scores"])))
    assert evaluate.strict_json(got) == evaluate.strict_json(want)
    assert set(got["AP_per_class"]) == set(NAMES)
    with open(dump) as f:
        dumped = json.load(f)
    assert len(dumped) == sum(records) > 0
    assert {d["category_id"] for d in dumped} <= {0, 1, 2}


def test_evaluate_cli_refuses_reordered_classes(artifacts, tmp_path):
    with pytest.raises(SystemExit, match="same order"):
        evaluate.main(["--dataset", "shapes", str(tmp_path), "2", "64",
                       "--from-export", artifacts[1], "--device", "cpu"])


@pytest.mark.parametrize("flags,item", [
    (["--experiment", "exp"], "A.4"), (["--step", "3"], "A.4"),
    (["--average-checkpoints", "2"], "A.4"), (["--data-parallel"], "A.7"),
    (["--spatial", "2"], "A.7")])
def test_evaluate_unported_flags_raise(artifacts, flags, item, capsys):
    """``--spatial`` (A.7's second part) raises naming A.7.  The flags
    ported since print the metrics of the export without them:
    ``--data-parallel`` (A.7's first part) on the CPU's one device, and
    the checkpoint flags (A.4) serving the experiment (``exp`` standing
    for it) of the same weights."""
    dataset = ["--dataset", "shapes", "unused", "2", "64", "--device", "cpu"]
    if "--spatial" in flags:
        with pytest.raises(SystemExit, match=item):
            evaluate.main([*dataset, "--from-export", artifacts[0], *flags])
        return
    evaluate.main([*dataset, "--from-export", artifacts[0]])
    want = capsys.readouterr().out
    if "--data-parallel" in flags:
        evaluate.main([*dataset, "--from-export", artifacts[0], *flags])
        assert capsys.readouterr().out == want
        return
    flags = [artifacts[2] if f == "exp" else f for f in flags]
    if "--experiment" not in flags:
        flags = ["--experiment", artifacts[2], *flags]
    evaluate.main([*dataset, *flags, "--backbone", "resnet_50_dense",
                   "--scale", "64"])
    assert capsys.readouterr().out == want


@pytest.fixture
def images(tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for i, (h, w) in enumerate(((64, 64), (40, 70), (90, 50))):
        path = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(path)
        paths.append(path)
    return paths


def test_load_batch_equals_jax(images):
    got = detect._load_batch(images, 64)
    want = jax_load_batch(images, 64)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for g, w in zip(got[2], want[2]):
        assert g.tobytes() == w.tobytes()


def test_detect_cli_dumps_detector_detect(artifacts, images, tmp_path):
    """Three images at batch 2 (the last chunk zero-padded), score 0.1."""
    dump, out = str(tmp_path / "d.json"), str(tmp_path / "out")
    detect.main([*images, "--from-export", artifacts[0], "--device", "cpu",
                 "--batch-size", "2", "--score-threshold", "0.1",
                 "--dump-json", dump, "--out", out])
    with open(dump) as f:
        got = json.load(f)

    config = Config()
    config = config.replace(
        data=dataclasses.replace(config.data, image_size=64, batch_size=2),
        nms=dataclasses.replace(config.nms, score_threshold=0.1))
    detector = load_exported_detector(artifacts[0], config, device="cpu")
    want = []
    for chunk in (images[:2], images[2:]):
        canvases, scales, _ = detect._load_batch(chunk, 64)
        pad = 2 - len(chunk)
        canvases = np.concatenate([canvases, np.zeros(
            (pad,) + canvases.shape[1:], np.float32)])
        scales = np.concatenate([scales, np.ones(pad, np.float32)])
        for path, det in zip(chunk, detector.detect(canvases, scales)):
            for box, score, cid in zip(det["boxes"], det["scores"],
                                       det["class_ids"]):
                want.append({"image": path, "class": NAMES[int(cid)],
                             "score": float(score),
                             "box_tlbr": [float(v) for v in box]})
    assert got == want and len(want) > 0
    assert sorted(os.listdir(out)) == ["img0.det.png", "img1.det.png",
                                       "img2.det.png"]


@pytest.mark.parametrize("flags", [["--experiment", "exp"], ["--step", "1"],
                                   []])
def test_detect_unported_flags_raise(artifacts, images, tmp_path, flags):
    """With neither ``--experiment`` nor ``--from-export`` detect raises;
    ``--experiment`` (``exp`` standing for it) and ``--step``, ported in
    A.4, dump the detections of the export of the same weights."""
    if not flags:
        with pytest.raises(SystemExit, match="need --experiment"):
            detect.main([*images, "--device", "cpu", *flags])
        return
    dumps = [str(tmp_path / "export.json"), str(tmp_path / "ckpt.json")]
    detect.main([*images, "--from-export", artifacts[0], "--device", "cpu",
                 "--score-threshold", "0.1", "--dump-json", dumps[0]])
    flags = [artifacts[2] if f == "exp" else f for f in flags]
    if "--experiment" not in flags:
        flags = ["--experiment", artifacts[2], *flags]
    detect.main([*images, *flags, "--backbone", "resnet_50_dense", "--scale",
                 "64", "--class-names", ",".join(NAMES), "--device", "cpu",
                 "--score-threshold", "0.1", "--dump-json", dumps[1]])
    records = []
    for dump in dumps:
        with open(dump) as f:
            records.append(json.load(f))
    assert records[1] == records[0] and len(records[0]) > 0
