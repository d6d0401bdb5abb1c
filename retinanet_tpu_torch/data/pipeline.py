"""Host-side input pipeline (a copy of ``retinanet_tpu/data/pipeline.py``),
the replacement for the reference's ``tf.data``.

The reference builds a TF graph pipeline with per-image dynamic shapes and a
fixed (image, flipped-image) pair as its "batch" (``dataset.py:145-233``).
The device programs want **static shapes** and real batches, so this
pipeline:

  * decodes + resizes on host (cv2/PIL, thread pool — cv2 releases the GIL)
  * resizes the *longer* side to fit a static canvas and pads — a square of
    ``image_size``, or the least-padding rectangular bucket when
    ``buckets`` is configured (batches are bucket-homogeneous; one compiled
    program per bucket).  The reference's shorter-side scaling gives
    dynamic shapes; padding regions carry no boxes and the
    assignment/losses are box-driven
  * ships training batches as raw uint8 (normalization happens on-device —
    4× less host→device transfer); eval batches stay normalized float
  * normalizes boxes to padded-canvas-relative [0, 1]
  * applies random horizontal flip on the host sample (image + boxes) —
    label maps are built *after* augmentation, on device, so there is no
    flip-the-labels step (the reference's ``augmentation.py`` flips 15 label
    tensors; here it's 1 image + 1 box array)
  * pads boxes/class_ids to a static ``max_boxes``
  * shuffles with a reservoir buffer and prefetches batches on a thread

Label assignment itself runs on-device (``ops/assign.py``) inside the jitted
train step.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

from retinanet_tpu_torch.config import DataConfig
from retinanet_tpu_torch.data.loaders.base import Base

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None
try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _bounded_map(pool, fn, iterable, window: int):
    """Ordered imap with a bounded number of in-flight futures.

    ``Executor.map`` submits its ENTIRE input eagerly — an epoch's memory
    becomes O(dataset) as every prepared sample waits in a completed
    future.  This submits at most ``window`` ahead of consumption
    (O(window) memory) and cancels the queued tail when the consumer
    stops early (part of the round-5 host-OOM fix; see
    ``Pipeline.prefetched``).
    """
    futures = collections.deque()
    try:
        for item in iterable:
            futures.append(pool.submit(fn, item))
            if len(futures) >= window:
                yield futures.popleft().result()
        while futures:
            yield futures.popleft().result()
    finally:
        for f in futures:
            f.cancel()


class Batch(NamedTuple):
    """One static-shape training batch (all host numpy, ready to copy to
    the device)."""

    images: np.ndarray      # [B, H, W, 3]: uint8 raw (training, on-device
                            # normalize) or float32 mean/std normalized (eval)
    boxes: np.ndarray       # [B, M, 4] float32 (t,l,b,r) canvas-relative
    class_ids: np.ndarray   # [B, M] int32
    box_mask: np.ndarray    # [B, M] bool
    image_ids: np.ndarray   # [B] int64 — loader sample index
    scales: np.ndarray      # [B] float32 — resize factor original→canvas px


def _no_codec(what: str) -> RuntimeError:
    return RuntimeError(f"{what} needs cv2 or PIL, and neither is "
                        f"installed; in-memory uint8 samples (the shapes "
                        f"loader) take the native path without them")


def _imread(path: str) -> np.ndarray:
    if cv2 is None and Image is None:
        raise _no_codec(f"reading {path}")
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1]  # BGR → RGB
    return np.asarray(Image.open(path).convert("RGB"))


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if cv2 is None and Image is None:
        raise _no_codec("resizing an image")
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


_LUMA_601 = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R BT.601


def photometric_jitter(image: np.ndarray, brightness: float, contrast: float,
                       saturation: float) -> np.ndarray:
    """Brightness/contrast/saturation jitter on a uint8 RGB image.

    The reference stubs photometric augmentation out entirely
    (its ``dataset.py:206-212`` — commented hue/saturation/
    brightness/contrast calls); this makes it a real host-side capability.
    Factors are multiplicative (1.0 = identity).  Applied before resize so
    the fused native resize+normalize path still sees one uint8 input.

    Formulations match torchvision's ColorJitter semantics: saturation
    blends each pixel with its BT.601 grayscale value; contrast blends
    with the mean of the grayscale image; each op clamps to [0, 255]
    before the next (torchvision's per-op uint8 saturation).
    """
    x = np.clip(image.astype(np.float32) * brightness, 0, 255)
    gray = x @ _LUMA_601  # [H, W] per-pixel BT.601 luma
    mean_gray = gray.mean()
    x = np.clip((x - mean_gray) * contrast + mean_gray, 0, 255)
    gray = (x @ _LUMA_601)[..., None]  # recompute on the contrasted image
    x = gray + (x - gray) * saturation
    return np.clip(x, 0, 255).astype(np.uint8)


def _canvas_hw(image_size) -> Tuple[int, int]:
    if isinstance(image_size, (tuple, list)):
        return int(image_size[0]), int(image_size[1])
    return int(image_size), int(image_size)


def select_canvas(sample: Dict, config: DataConfig):
    """(possibly-updated sample, canvas (h, w)) for one sample: the square
    ``image_size`` canvas, or the least-padding bucket (decoding the image
    once and caching it on the sample).  The single source of bucket
    geometry for BOTH the training pipeline and ``evaluate_model`` — the
    two must agree or eval runs under different padding than training."""
    if not config.buckets:
        return sample, _canvas_hw(config.image_size)
    image = sample.get("image")
    if image is None:
        image = _imread(sample["image_file"])
        sample = {**sample, "image": image}
    return sample, pick_bucket(image.shape[0], image.shape[1],
                               config.buckets)


def pick_bucket(ih: int, iw: int, buckets) -> Tuple[int, int]:
    """Bucket with the least padding waste for an (ih, iw) image, after
    aspect-preserving scaling to fit — rectangular canvases cut the padding
    FLOPs square canvases waste on non-square datasets."""
    best = None
    for bh, bw in buckets:
        scale = min(bh / ih, bw / iw)
        waste = bh * bw - (ih * scale) * (iw * scale)
        if best is None or waste < best[0]:
            best = (waste, (int(bh), int(bw)))
    return best[1]


def process_sample(sample: Dict, image_size, mean: np.ndarray,
                   std: np.ndarray, max_boxes: int, flip: bool,
                   photometric: Optional[Tuple[float, float, float]] = None,
                   scale_jitter: Optional[float] = None,
                   use_native: bool = True,
                   normalize_on_host: bool = True) -> Dict[str, np.ndarray]:
    """Decode/resize/pad/normalize one sample to static shapes.

    ``image_size``: int (square canvas) or (h, w) (rectangular bucket).
    Boxes are normalized per-dimension to canvas-relative [0, 1]².

    ``normalize_on_host=False`` returns the canvas as raw uint8 (resize+pad
    only) for on-device normalization — 4× less host→device transfer.

    With ``use_native`` (and a uint8 image), resize + [0,1] scaling +
    mean/std normalization + padding run as one fused multithreaded C++ pass
    (``host/retinanet_host.cc``; a failed build raises); the numpy/cv2 path,
    which the caller picks with ``use_native=False``, is the correctness
    reference.
    """
    image = sample.get("image")
    if image is None:
        image = _imread(sample["image_file"])
    if photometric is not None and image.dtype == np.uint8:
        image = photometric_jitter(image, *photometric)
    ih, iw = image.shape[:2]
    ch, cw = _canvas_hw(image_size)

    scale = min(ch / ih, cw / iw)
    if scale_jitter is not None:
        # Zoom-out augmentation: shrink the resize target; geometry below
        # (boxes, padding, normalization) flows through unchanged, so
        # labels stay exactly consistent with the rendered canvas.
        scale *= min(max(scale_jitter, 1e-3), 1.0)
    nh, nw = max(1, round(ih * scale)), max(1, round(iw * scale))
    boxes = sample["boxes"].astype(np.float32) * scale  # canvas pixels
    class_ids = sample["class_ids"].astype(np.int32)

    if flip:
        # Mirror the source first (bilinear resize commutes with mirroring),
        # so the fused native path sees a single contiguous uint8 input.
        image = np.ascontiguousarray(image[:, ::-1])
        t, l, b, r = np.split(boxes, 4, axis=-1)
        boxes = np.concatenate([t, nw - r, b, nw - l], axis=-1)

    canvas = None
    if not normalize_on_host:
        resized = _resize(image.astype(np.uint8, copy=False), nh, nw)
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = resized
    if canvas is None and use_native and image.dtype == np.uint8:
        from retinanet_tpu_torch import native
        canvas = native.resize_normalize(image, (ch, cw), nh, nw,
                                         mean, std)
    if canvas is None:
        resized = _resize(image, nh, nw)
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:nh, :nw] = resized.astype(np.float32) / 255.0
        canvas = (canvas - mean) / std

    # Canvas-relative [0, 1] per dimension ((t,l,b,r) / (H,W,H,W)).
    boxes = boxes / np.asarray([ch, cw, ch, cw], np.float32)
    n = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_ids = np.zeros((max_boxes,), np.int32)
    out_mask = np.zeros((max_boxes,), bool)
    out_boxes[:n] = boxes[:n]
    out_ids[:n] = class_ids[:n]
    out_mask[:n] = True

    return {"image": canvas, "boxes": out_boxes, "class_ids": out_ids,
            "box_mask": out_mask, "scale": np.float32(scale)}


class Pipeline:
    """Iterable over :class:`Batch`es with shuffle + threaded prefetch.

    ``scheduled_canvases=True`` (multi-process mode) replaces per-batch
    least-padding bucket choice with a **deterministic canvas schedule**:
    the canvas of global step *t* is drawn from a seeded RNG that depends
    only on (seed, epoch, t) — identical on every process — so
    the processes always assemble shards of one agreed shape.  Each process
    keeps per-ideal-bucket queues and
    fills the scheduled batch preferring samples whose least-padding
    bucket matches, falling back to the longest queue (any image renders
    onto any canvas — bucket mismatch costs padding, never correctness).
    """

    def __init__(self, loader: Base, config: DataConfig,
                 max_boxes: int = 100, training: bool = True,
                 seed: int = 42, scheduled_canvases: bool = False,
                 schedule_seed: Optional[int] = None):
        if not 0.0 <= config.augment_scale_jitter < 1.0:
            # J >= 1 would draw negative resize factors (the documented
            # semantics are U[1-J, 1]) and silently shrink images to ~1px.
            raise ValueError(
                f"augment_scale_jitter must be in [0, 1), got "
                f"{config.augment_scale_jitter}")
        self.loader = loader
        self.config = config
        self.max_boxes = max_boxes
        self.training = training
        self.seed = seed
        self.pair_flip = bool(config.pair_flip_batching and training)
        if self.pair_flip and config.batch_size % 2:
            raise ValueError(
                "pair_flip_batching needs an even batch_size (each image "
                f"contributes itself + its flip), got {config.batch_size}")
        self.scheduled_canvases = bool(scheduled_canvases and config.buckets)
        # The schedule must be drawn from PROCESS-SHARED state: train.py
        # seeds per-process pipelines with seed+process_index (shuffle may
        # diverge) but passes the bare train seed here so every process
        # draws the identical canvas sequence.
        self.schedule_seed = self.seed if schedule_seed is None \
            else int(schedule_seed)
        self._mean = np.asarray(config.mean, np.float32)
        self._std = np.asarray(config.std, np.float32)

    def __len__(self) -> int:
        n = len(self.loader) * (2 if self.pair_flip else 1)
        return max(1, n // self.config.batch_size)

    def _sample_stream(self, rng: np.random.RandomState) -> Iterator[tuple]:
        """(index, sample) stream with reservoir shuffle when training."""
        indexed = enumerate(self.loader)
        if not self.training or self.config.shuffle_buffer <= 1:
            yield from indexed
            return
        buf = []
        for item in indexed:
            buf.append(item)
            if len(buf) >= self.config.shuffle_buffer:
                j = rng.randint(len(buf))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def epoch(self, epoch_index: int = 0) -> Iterator[Batch]:
        """One pass over the loader as static-shape batches (drops the final
        short batch — static shapes everywhere)."""
        cfg = self.config
        rng = np.random.RandomState(self.seed * 131 + epoch_index)

        def with_augment_draws():
            # Draw augmentation decisions sequentially here (single thread)
            # so the rng is not shared across pool workers and runs are
            # reproducible regardless of worker scheduling.
            for index, sample in self._sample_stream(rng):
                photometric = None
                if cfg.augment_photometric and self.training:
                    s = cfg.photometric_strength
                    photometric = tuple(rng.uniform(1 - s, 1 + s, 3))
                jitter = None
                if cfg.augment_scale_jitter > 0 and self.training:
                    jitter = float(
                        1.0 - rng.uniform(0.0, cfg.augment_scale_jitter))
                if self.pair_flip:
                    # Reference-parity batch construction
                    # (``dataset.py:182-204``): both orientations of every
                    # image as adjacent entries; the photometric/scale
                    # draws are shared so the pair differs only by flip.
                    yield index, sample, False, photometric, jitter
                    yield index, sample, True, photometric, jitter
                    continue
                flip = bool(cfg.augment_flip and self.training
                            and rng.rand() < 0.5)
                yield index, sample, flip, photometric, jitter

        def prepare(item, canvas_override=None):
            index, sample, flip, photometric, jitter = item
            if canvas_override is None:
                sample, canvas = select_canvas(sample, cfg)
            else:
                # Scheduled mode: render onto the step's agreed canvas
                # (image already decoded by the classify stage).
                canvas = canvas_override
            out = process_sample(
                sample, canvas, self._mean, self._std, self.max_boxes,
                flip, photometric=photometric, scale_jitter=jitter,
                normalize_on_host=not (self.training
                                       and cfg.transfer_uint8))
            out["image_id"] = np.int64(index)
            out["canvas"] = canvas
            return out

        def make_batch(samples):
            return Batch(
                images=np.stack([s["image"] for s in samples]),
                boxes=np.stack([s["boxes"] for s in samples]),
                class_ids=np.stack([s["class_ids"] for s in samples]),
                box_mask=np.stack([s["box_mask"] for s in samples]),
                image_ids=np.stack([s["image_id"] for s in samples]),
                scales=np.stack([s["scale"] for s in samples]),
            )

        with ThreadPoolExecutor(max_workers=cfg.num_workers) as pool:
            if self.scheduled_canvases:
                yield from self._scheduled_batches(
                    pool, with_augment_draws(), prepare, make_batch,
                    epoch_index)
                return
            # One accumulator per canvas: with buckets enabled, a batch is
            # homogeneous in canvas shape (one compiled program per bucket);
            # without buckets there is a single accumulator.  Per-bucket
            # remainders are dropped like the final short batch.
            pending: Dict[tuple, list] = {}
            for processed in _bounded_map(pool, prepare, with_augment_draws(),
                                          window=cfg.num_workers * 2 + 2):
                key = tuple(np.shape(processed["image"])[:2])
                bucket = pending.setdefault(key, [])
                bucket.append(processed)
                if len(bucket) == cfg.batch_size:
                    yield make_batch(pending.pop(key))

    def _scheduled_batches(self, pool, stream, prepare, make_batch,
                           epoch_index: int) -> Iterator[Batch]:
        """Deterministic-canvas batching (see class docstring).

        Batch *t*'s canvas comes from an RNG seeded only with
        (schedule_seed, epoch) — every process draws the same sequence, so
        the t-th batch has the same shape everywhere and
        the processes always assemble it cleanly.
        Unlike least-padding batching there are NO per-bucket remainder
        drops: every sample is used (any image renders onto any canvas),
        so each process yields exactly ``len(shard) // batch_size``
        batches — which keeps train.py's ``_sync_steps_per_epoch``
        arithmetic exact.
        """
        cfg = self.config
        buckets = [tuple(map(int, b)) for b in cfg.buckets]
        sched = np.random.RandomState(
            (self.schedule_seed * 977 + epoch_index * 9176 + 13) % (2**31))
        queues = {b: [] for b in buckets}
        pending = 0
        # Buffer a few batches of lookahead so the scheduled canvas usually
        # finds matching (least-padding-ideal) samples waiting.
        lookahead = cfg.batch_size * max(2, len(buckets))

        def classify(item):
            index, sample, flip, photometric, jitter = item
            sample, ideal = select_canvas(sample, cfg)
            return (index, sample, flip, photometric, jitter), ideal

        def emit():
            canvas = buckets[sched.randint(len(buckets))]
            q = queues[canvas]
            chosen = q[:cfg.batch_size]
            del q[:len(chosen)]
            while len(chosen) < cfg.batch_size:
                # Mismatch fallback: drain the longest queue — costs
                # padding on this batch, never correctness.
                chosen.append(max(queues.values(), key=len).pop(0))
            return make_batch(list(pool.map(
                lambda it: prepare(it, canvas_override=canvas), chosen)))

        for item, ideal in _bounded_map(pool, classify, stream,
                                        window=cfg.num_workers * 2 + 2):
            queues[ideal].append(item)
            pending += 1
            if pending >= lookahead:
                yield emit()
                pending -= cfg.batch_size
        while pending >= cfg.batch_size:
            yield emit()
            pending -= cfg.batch_size

    def prefetched(self, epoch_index: int = 0) -> Iterator[Batch]:
        """epoch() with a background producer thread.

        Abandonment-safe: a consumer that stops early (``--steps-per-epoch``
        breaks the train loop every epoch) closes this generator, which
        signals the producer to stop and closes the underlying ``epoch()``
        generator (shutting down its thread pool).  Without that, every
        abandoned epoch leaked the producer thread blocked on ``q.put``
        plus the pool and its pending batches — ~1 batch of host RAM per
        epoch, enough to OOM a 125 GB host in a 2400-step @b128 run
        (round-5 incident, reproduced and tracemalloc'd on CPU).
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.config.prefetch)
        sentinel = object()
        stop = threading.Event()
        error = []

        def produce():
            gen = self.epoch(epoch_index)
            try:
                for b in gen:
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        break
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                gen.close()  # unwinds epoch()'s ThreadPoolExecutor
                # The end of the epoch must reach a consumer still reading,
                # however full the queue: a slower consumer (a training
                # step that outlasts a batch's preparation) would otherwise
                # wait on q.get() forever after the last batch.
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30)


def build_pipeline(loader: Base, config: DataConfig, max_boxes: int = 100,
                   training: bool = True, seed: int = 42,
                   scheduled_canvases: bool = False,
                   schedule_seed: Optional[int] = None) -> Pipeline:
    """Reference ``dataset.build_dataset`` equivalent (``dataset.py:154``)."""
    return Pipeline(loader, config, max_boxes=max_boxes, training=training,
                    seed=seed, scheduled_canvases=scheduled_canvases,
                    schedule_seed=schedule_seed)


def compute_mean_std(loader: Base, image_size: int = 256,
                     max_samples: Optional[int] = None):
    """Two-pass channel mean/std (fixes the reference's broken
    ``dataset.py:236-277`` CLI).  Operates on unnormalized [0,1] pixels of
    the un-padded region."""
    total = np.zeros(3, np.float64)
    count = 0
    sizes = []
    for i, sample in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        image = sample.get("image")
        if image is None:
            image = _imread(sample["image_file"])
        x = image.astype(np.float64) / 255.0
        total += x.sum((0, 1))
        count += x.shape[0] * x.shape[1]
        sizes.append(x.shape[:2])
    mean = total / count

    sq = np.zeros(3, np.float64)
    for i, sample in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        image = sample.get("image")
        if image is None:
            image = _imread(sample["image_file"])
        x = image.astype(np.float64) / 255.0
        sq += ((x - mean) ** 2).sum((0, 1))
    std = np.sqrt(sq / count)
    return mean, std
