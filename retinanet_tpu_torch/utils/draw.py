"""Host-side visualization (a copy of ``retinanet_tpu/utils/draw.py``; the
reference's ``utils.py:120-148`` + ``train.py:52-85``).

The reference renders box overlays *inside the graph* via ``tf.py_func`` —
a device→host callback mid-step.  Here drawing is a pure post-step host
function over numpy arrays; the trainer writes PNGs next to the metrics.
Deterministic per-class colors (seeded rng, like the reference).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def class_colors(num_classes: int) -> List[tuple]:
    """Deterministic per-class BGR colors (reference ``utils.py:121-122``)."""
    rng = np.random.RandomState(42)
    return [tuple(float(c) for c in rng.uniform(0, 255, 3))
            for _ in range(num_classes)]


def draw_bounding_boxes(image: np.ndarray, boxes: np.ndarray,
                        class_ids: np.ndarray, class_names: List[str],
                        scores: Optional[np.ndarray] = None,
                        font_scale: float = 0.3) -> np.ndarray:
    """Render labelled boxes; ``boxes`` are (t,l,b,r) relative [0,1]."""
    image = np.ascontiguousarray(np.copy(image))
    if image.dtype != np.uint8:
        image = np.clip(image * 255, 0, 255).astype(np.uint8)
    colors = class_colors(len(class_names))
    h, w = image.shape[:2]
    scale = np.array([h, w, h, w], np.float32)
    px = (np.asarray(boxes) * scale).round().astype(np.int32)

    if cv2 is None:  # numpy fallback: 1px rectangles
        for box, cid in zip(px, class_ids):
            t, l, b, r = np.clip(box, 0, [h - 1, w - 1, h - 1, w - 1])
            color = np.asarray(colors[int(cid)], np.uint8)
            image[t, l:r] = color
            image[b, l:r] = color
            image[t:b, l] = color
            image[t:b, r] = color
        return image

    for i, (box, cid) in enumerate(zip(px, class_ids)):
        cid = int(cid)
        label = class_names[cid]
        if scores is not None:
            label = f"{label} {scores[i]:.2f}"
        color = colors[cid]
        cv2.rectangle(image, (box[1], box[0]), (box[3], box[2]), color, 1)
        (tw, th), baseline = cv2.getTextSize(
            label, cv2.FONT_HERSHEY_SIMPLEX, font_scale, 1)
        box_off, text_off = (-th - baseline, 0), -baseline
        if box[0] + box_off[0] < 0:
            box_off, text_off = (0, th + baseline), th
        cv2.rectangle(image, (box[1], box[0] + box_off[0]),
                      (box[1] + tw, box[0] + box_off[1]), color, -1)
        text_color = (0, 0, 0) if np.mean(color) > 127 else (255, 255, 255)
        cv2.putText(image, label, (box[1], box[0] + text_off),
                    cv2.FONT_HERSHEY_SIMPLEX, font_scale, text_color,
                    lineType=cv2.LINE_AA)
    return image


def draw_classmap(image: np.ndarray, fg_counts: np.ndarray) -> np.ndarray:
    """Overlay an upsampled fg-anchor-count heat map on the image
    (reference ``train.py:52-66``)."""
    if image.dtype != np.uint8:
        image = np.clip(image * 255, 0, 255).astype(np.uint8)
    h, w = image.shape[:2]
    heat = fg_counts.astype(np.float32)
    if heat.max() > 0:
        heat = heat / heat.max()
    if cv2 is not None:
        heat = cv2.resize(heat, (w, h), interpolation=cv2.INTER_NEAREST)
    else:
        ry, rx = h // heat.shape[0] + 1, w // heat.shape[1] + 1
        heat = np.kron(heat, np.ones((ry, rx)))[:h, :w]
    overlay = image.astype(np.float32)
    overlay[..., 2] = np.clip(overlay[..., 2] + heat * 128, 0, 255)
    return overlay.astype(np.uint8)
