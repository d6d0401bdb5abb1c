"""Synthetic shapes dataset (a copy of ``retinanet_tpu/data/loaders/shapes.py``).

Random squares / triangles / circles with exact ground-truth boxes — makes the
whole pipeline runnable and testable with zero downloads.  Same generation
scheme as the reference (random background, 1-4 shapes, numpy NMS at IoU 0.3
to avoid heavy overlap); differences: images are generated in memory and only
optionally written to disk, and generation is seeded + deterministic per
index, so the dataset is reproducible and epoch-stable.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from retinanet_tpu_torch.data.loaders.base import Base

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _np_nms(boxes: np.ndarray, scores: np.ndarray,
            threshold: float) -> np.ndarray:
    """Greedy numpy NMS (reference ``shapes.py:84-118``)."""
    boxes = boxes.astype(np.float32)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        y1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        x1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        y2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        x2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
        iou = inter / (areas[i] + areas[rest] - inter)
        order = rest[iou <= threshold]
    return np.array(keep, dtype=np.int32)


class Shapes(Base):
    """``Shapes(path, num_samples, (h, w))`` — path used only if ``write``."""

    _CLASS_NAMES = ["square", "triangle", "circle"]

    def __init__(self, path: Optional[str], num_samples: int,
                 image_size: Tuple[int, int], seed: int = 42,
                 write: bool = False, cache: bool = True):
        self._path = path
        self._num_samples = int(num_samples)
        self._image_size = tuple(int(s) for s in image_size)
        self._seed = seed
        self._write = write and path is not None
        # Samples are deterministic per index; cache them so epochs after the
        # first skip the cv2 drawing work (the reference re-renders PNGs on
        # every pass, shapes.py:31-53).
        self._cache = {} if cache else None

    @property
    def class_names(self) -> List[str]:
        return list(self._CLASS_NAMES)

    def __len__(self) -> int:
        return self._num_samples

    def _sample(self, index: int) -> Dict:
        rng = np.random.RandomState(self._seed * 1_000_003 + index)
        h, w = self._image_size
        bg = rng.randint(0, 255, size=3)
        image = np.ones((h, w, 3), np.uint8) * bg.astype(np.uint8)

        # Reference uses a fixed 20px buffer (shapes.py:137) which breaks for
        # canvases under ~88px — scale it down for small test images.
        buffer = max(2, min(20, h // 4, w // 4))
        s_lo = max(2, min(buffer, h // 8))
        s_hi = max(s_lo + 1, h // 4 + 1)
        n = rng.randint(1, 5)
        shapes = []
        boxes = []
        for _ in range(n):
            shape = self._CLASS_NAMES[rng.randint(3)]
            color = tuple(int(c) for c in rng.randint(0, 256, size=3))
            y = rng.randint(buffer, h - buffer)
            x = rng.randint(buffer, w - buffer)
            s = rng.randint(s_lo, s_hi)
            shapes.append((shape, color, (x, y, s)))
            boxes.append([y - s, x - s, y + s, x + s])
        keep = _np_nms(np.array(boxes, np.float32), np.arange(n)[::-1].astype(
            np.float32), 0.3)
        shapes = [shapes[i] for i in keep]

        out_boxes, out_ids = [], []
        for shape, color, (x, y, s) in shapes:
            self._draw(image, shape, (x, y, s), color)
            # Clip to the canvas so t<b, l<r in-image (reference keeps
            # out-of-image extents; we clip for valid normalized labels).
            out_boxes.append([max(y - s, 0), max(x - s, 0),
                              min(y + s, h), min(x + s, w)])
            out_ids.append(self._CLASS_NAMES.index(shape))

        sample = {
            "image": image,
            "class_ids": np.array(out_ids, np.int32),
            "boxes": np.array(out_boxes, np.float32).reshape(-1, 4),
        }
        if self._write:
            os.makedirs(self._path, exist_ok=True)
            image_file = os.path.join(self._path, f"{index}.png")
            if cv2 is not None:
                cv2.imwrite(image_file, image[..., ::-1])
            sample["image_file"] = image_file
        return sample

    @staticmethod
    def _draw(image: np.ndarray, shape: str, dims: Tuple[int, int, int],
              color: Tuple[int, int, int]) -> None:
        x, y, s = dims
        if cv2 is None:  # numpy fallback: axis-aligned fill
            t, l = max(y - s, 0), max(x - s, 0)
            b, r = min(y + s, image.shape[0]), min(x + s, image.shape[1])
            image[t:b, l:r] = color
            return
        if shape == "square":
            cv2.rectangle(image, (x - s, y - s), (x + s, y + s), color, -1)
        elif shape == "circle":
            cv2.circle(image, (x, y), s, color, -1)
        else:  # triangle
            k = s / math.sin(math.radians(60))
            pts = np.array([[(x, y - s), (x - k, y + s), (x + k, y + s)]],
                           np.int32)
            cv2.fillPoly(image, pts, color)

    def __iter__(self) -> Iterator[Dict]:
        for i in range(self._num_samples):
            if self._cache is None:
                yield self._sample(i)
            else:
                if i not in self._cache:
                    self._cache[i] = self._sample(i)
                yield self._cache[i]
