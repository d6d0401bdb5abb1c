"""The port's host data path (``retinanet_tpu_torch.data``, ``native``)
against the JAX package's, bitwise on the same seeded inputs: the Shapes,
COCO and Pascal loaders (eval and train mode), ``select_canvas`` and
``process_sample`` on the native path (each package builds its own copy of
the same C++ source) and on the numpy path, one epoch of ``build_pipeline``
batches, ``compute_mean_std`` and its CLI.  The port's host library is
built from its own source into ``build/host/``, and a failed build raises.
Every case runs at ≤ 64 px on ≤ 8 images."""

import json
import os
import threading
import time
import xml.sax.saxutils

import numpy as np
import pytest
from PIL import Image

from retinanet_tpu import native as jnative
from retinanet_tpu.config import DataConfig as JDataConfig
from retinanet_tpu.data import pipeline as jpipe
from retinanet_tpu.data import stats as jstats
from retinanet_tpu.data.loaders.inferred import Inferred as JInferred
from retinanet_tpu.data.loaders.shapes import Shapes as JShapes
from retinanet_tpu_torch import native
from retinanet_tpu_torch.config import DataConfig
from retinanet_tpu_torch.data import pipeline
from retinanet_tpu_torch.data import stats
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.data.loaders.shapes import Shapes

MEAN = np.asarray(DataConfig().mean, np.float32)
STD = np.asarray(DataConfig().std, np.float32)


def assert_samples_equal(got, want):
    """Same keys; arrays equal in dtype, shape and every bit; other
    values equal."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
        else:
            assert g == w and type(g) is type(w), key


def assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_samples_equal(g, w)


@pytest.mark.parametrize("size", [(64, 64), (40, 64)])
def test_shapes_samples_equal_jax(size):
    got = Shapes(None, 8, size, seed=3)
    want = JShapes(None, 8, size, seed=3)
    assert got.class_names == want.class_names and len(got) == len(want)
    assert_streams_equal(got, want)


def _write_images(directory, names, seed):
    """Random RGB files written with PIL (PNG, so the pixels survive)."""
    rng = np.random.RandomState(seed)
    sizes = []
    for i, name in enumerate(names):
        h, w = (48, 64) if i % 2 else (64, 40)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(directory, name), format="PNG")
        sizes.append((h, w))
    return sizes


@pytest.fixture
def coco_dir(tmp_path):
    """Four images: boxes in two classes (ids 7 and 3, re-indexed sorted),
    a crowd, a degenerate box and an annotation-free image."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    names = [f"im{i}.jpg" for i in range(4)]
    sizes = _write_images(str(img_dir), names, seed=0)
    anns = [
        (1, 7, [4, 6, 20, 30], 0, None), (1, 3, [30, 2, 8, 10], 0, 50.0),
        (2, 7, [1, 1, 0.5, 10], 0, None), (2, 3, [10, 10, 30, 20], 1, 400.0),
        (2, 7, [5, 8, 16, 16], 0, None), (4, 3, [0, 0, 40, 48], 0, None),
    ]
    ann = {
        "images": [{"id": i + 1, "file_name": n, "width": w, "height": h}
                   for i, (n, (h, w)) in enumerate(zip(names, sizes))],
        "categories": [{"id": 7, "name": "cat"}, {"id": 3, "name": "dog"}],
        "annotations": [
            {"id": k, "image_id": im, "category_id": cat, "bbox": bbox,
             "iscrowd": crowd, **({} if area is None else {"area": area})}
            for k, (im, cat, bbox, crowd, area) in enumerate(anns)],
    }
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(ann))
    return [str(path), str(img_dir)]


@pytest.fixture
def pascal_dir(tmp_path):
    """Three images with dog/person/car objects, difficult flags 1, 0 and
    an empty tag."""
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (tmp_path / sub).mkdir(parents=True)
    names = ["a", "b", "c"]
    _write_images(str(tmp_path / "JPEGImages"), [n + ".jpg" for n in names],
                  seed=1)
    (tmp_path / "ImageSets/Main/val.txt").write_text("\n".join(names) + "\n")
    objects = {"a": [("dog", (4, 6, 30, 20), "1"), ("person", (1, 2, 9, 8),
                                                     "0")],
               "b": [("car", (10, 3, 40, 30), "")],
               "c": [("dog", (0, 0, 47, 63), None)]}
    for name, objs in objects.items():
        body = ""
        for cls, (t, l, b, r), difficult in objs:
            tag = ("" if difficult is None else
                   f"<difficult>{difficult}</difficult>")
            body += (f"<object><name>{xml.sax.saxutils.escape(cls)}</name>"
                     f"{tag}<bndbox><ymin>{t}</ymin><xmin>{l}</xmin>"
                     f"<ymax>{b}</ymax><xmax>{r}</xmax></bndbox></object>")
        (tmp_path / "Annotations" / f"{name}.xml").write_text(
            f"<annotation>{body}</annotation>")
    return [str(tmp_path), "val"]


@pytest.mark.parametrize("kind", ["coco", "pascal"])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_file_loaders_equal_jax(kind, eval_mode, coco_dir, pascal_dir):
    """Loaders through the dispatcher, in train and eval mode; each sample
    then through ``process_sample`` (image read from the file)."""
    args = coco_dir if kind == "coco" else pascal_dir
    got = Inferred(kind, args, include_crowds=eval_mode)
    want = JInferred(kind, args, include_crowds=eval_mode)
    assert got.class_names == want.class_names and len(got) == len(want)
    assert got.coco_category_ids == want.coco_category_ids
    assert_streams_equal(got, want)
    for g, w in zip(got, want):
        assert_samples_equal(
            pipeline.process_sample(g, (64, 48), MEAN, STD, 4, flip=True),
            jpipe.process_sample(w, (64, 48), MEAN, STD, 4, flip=True))


def _samples(seed=5):
    """uint8 images of four aspect ratios, with boxes."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in ((64, 64), (40, 64), (64, 36), (30, 30)):
        ys = np.sort(rng.uniform(0, h, (3, 2)), 1)
        xs = np.sort(rng.uniform(0, w, (3, 2)), 1)
        boxes = np.stack([ys[:, 0], xs[:, 0], ys[:, 1], xs[:, 1]], 1)
        out.append({"image": rng.randint(0, 256, (h, w, 3), np.uint8),
                    "boxes": boxes.astype(np.float32),
                    "class_ids": rng.randint(0, 3, 3).astype(np.int32)})
    return out


@pytest.mark.parametrize("buckets", [None, ((64, 64), (48, 64), (64, 40))])
@pytest.mark.parametrize("use_native", [True, False])
def test_select_canvas_and_process_sample_equal_jax(buckets, use_native):
    cfg = DataConfig(image_size=64, buckets=buckets)
    jcfg = JDataConfig(image_size=64, buckets=buckets)
    options = [dict(flip=False), dict(flip=True),
               dict(flip=True, photometric=(1.2, 0.8, 1.1),
                    scale_jitter=0.7),
               dict(flip=False, normalize_on_host=False)]
    for sample in _samples():
        s_got, canvas = pipeline.select_canvas(sample, cfg)
        s_want, j_canvas = jpipe.select_canvas(sample, jcfg)
        assert canvas == j_canvas
        assert_samples_equal(s_got, s_want)
        for opt in options:
            assert_samples_equal(
                pipeline.process_sample(s_got, canvas, MEAN, STD, 2,
                                        use_native=use_native, **opt),
                jpipe.process_sample(s_want, canvas, MEAN, STD, 2,
                                     use_native=use_native, **opt))


class _Listed:
    """A loader over a fixed list of samples."""

    def __init__(self, samples, names=("a", "b", "c")):
        self.samples, self.class_names = samples, list(names)
        self.num_classes = len(names)

    def __len__(self):
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)


@pytest.mark.parametrize("mode", ["train", "eval", "scheduled"])
def test_pipeline_epoch_equals_jax(mode):
    """One epoch of batches, seeded: training with flip, photometric and
    scale jitter on (uint8 transfer), evaluation (normalized float), and
    the scheduled-canvas batching over buckets."""
    samples = _samples(6) + _samples(7)
    kw = dict(image_size=64, batch_size=2, shuffle_buffer=4, num_workers=2,
              augment_photometric=True, augment_scale_jitter=0.3)
    if mode != "train":
        kw["buckets"] = ((64, 64), (48, 64))
    training = mode != "eval"
    sched = mode == "scheduled"
    got = pipeline.build_pipeline(_Listed(samples), DataConfig(**kw),
                                  max_boxes=4, training=training, seed=11,
                                  scheduled_canvases=sched)
    want = jpipe.build_pipeline(_Listed(samples), JDataConfig(**kw),
                                max_boxes=4, training=training, seed=11,
                                scheduled_canvases=sched)
    assert len(got) == len(want)
    for epoch in (0, 1):
        g_batches = list(got.epoch(epoch))
        w_batches = list(want.epoch(epoch))
        assert len(g_batches) == len(w_batches) > 0
        for g, w in zip(g_batches, w_batches):
            assert_samples_equal(g._asdict(), w._asdict())
    prefetched = got.prefetched(0)
    assert_samples_equal(next(prefetched)._asdict(),
                         next(iter(want.epoch(0)))._asdict())
    prefetched.close()


def test_prefetched_epoch_ends_for_a_slow_consumer():
    """A consumer slower than the producer reads a whole prefetched epoch
    and sees it end: the producer finishes with the queue full, and the
    end of the epoch must still reach the consumer."""
    config = DataConfig(image_size=64, batch_size=2, prefetch=2,
                        num_workers=2)
    pipe = pipeline.build_pipeline(_Listed(_samples(6) + _samples(7)),
                                   config, max_boxes=4, training=True,
                                   seed=11)
    got = []

    def consume():
        for batch in pipe.prefetched(0):
            time.sleep(0.2)  # the producer refills the queue meanwhile
            got.append(batch)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    reader.join(timeout=30)
    assert not reader.is_alive(), "the epoch never ended"
    assert len(got) == len(pipe) == len(list(pipe.epoch(0)))


def test_compute_mean_std_equals_jax(capsys):
    loader, j_loader = Shapes(None, 6, (48, 64)), JShapes(None, 6, (48, 64))
    for max_samples in (None, 4):
        got = pipeline.compute_mean_std(loader, max_samples=max_samples)
        want = jpipe.compute_mean_std(j_loader, max_samples=max_samples)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    args = ["--dataset", "shapes", "unused", "5", "48"]
    stats.main(args)
    jstats.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]


def test_native_library_equals_jax():
    """The port's library, built from its own copy of the source, against
    the JAX package's: resize+normalize, bitwise."""
    assert native.LIB.build().parent == native.BUILD_DIR
    assert native.LIB.source.read_text().split("extern \"C\"", 1)[1] == \
        open(os.path.join(os.path.dirname(jnative.__file__), os.pardir,
                          "native", "retinanet_host.cc")).read().split(
            "extern \"C\"", 1)[1]
    rng = np.random.RandomState(8)
    image = rng.randint(0, 256, (50, 30, 3), np.uint8)
    for canvas, nh, nw in ((64, 64, 38), ((48, 64), 37, 22), (32, 32, 32)):
        got = native.resize_normalize(image, canvas, nh, nw, MEAN, STD)
        want = jnative.resize_normalize(image, canvas, nh, nw, MEAN, STD)
        assert got.tobytes() == want.tobytes()


def test_native_build_failure_raises(tmp_path):
    """No numpy fallback: a missing compiler or a compile error raises,
    with the compiler's message."""
    missing = native.HostLibrary(build_dir=tmp_path,
                                 compiler=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        missing.lib
    bad = tmp_path / "bad.cc"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    broken = native.HostLibrary(source=bad, build_dir=tmp_path)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        broken.lib
    assert not list(tmp_path.glob("*.so"))
