"""Pascal VOC loader (a copy of ``retinanet_tpu/data/loaders/pascal.py``).

Reads ``ImageSets/Main/<subset>.txt`` and the per-image XML annotations; the
20 VOC class names are fixed.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List

import numpy as np

from retinanet_tpu_torch.data.loaders.base import Base

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class Pascal(Base):
    def __init__(self, path: str, subset: str,
                 include_difficult_flags: bool = False):
        """``include_difficult_flags`` is the VOC evaluation mode: samples
        gain a ``difficult`` bool array (the official protocol ignores
        difficult GTs — neither recall targets nor false-positive
        sources).  Training keeps difficult objects as ordinary positives
        either way — exactly the reference's behaviour, which never parses
        the flag (its ``data_loaders/pascal.py:36-43``)."""
        self._path = path
        self._subset = subset
        self._include_difficult_flags = include_difficult_flags
        with open(os.path.join(path, "ImageSets", "Main",
                               subset + ".txt")) as f:
            self._image_names = [line.strip().split()[0]
                                 for line in f if line.strip()]

    @property
    def class_names(self) -> List[str]:
        return list(VOC_CLASSES)

    def __len__(self) -> int:
        return len(self._image_names)

    def __iter__(self) -> Iterator[Dict]:
        for name in self._image_names:
            tree = ET.parse(os.path.join(self._path, "Annotations",
                                         name + ".xml"))
            boxes, class_ids, difficult = [], [], []
            for obj in tree.getroot().iter("object"):
                t = float(obj.find("bndbox/ymin").text)
                l = float(obj.find("bndbox/xmin").text)
                b = float(obj.find("bndbox/ymax").text)
                r = float(obj.find("bndbox/xmax").text)
                boxes.append([t, l, b, r])
                class_ids.append(VOC_CLASSES.index(obj.find("name").text))
                node = obj.find("difficult")
                # Some annotation tools emit empty <difficult/> tags
                # (node.text is None) — treat as not-difficult.
                difficult.append(node is not None
                                 and (node.text or "").strip() == "1")
            sample = {
                "image_file": os.path.join(self._path, "JPEGImages",
                                           name + ".jpg"),
                "class_ids": np.array(class_ids, np.int32),
                "boxes": np.array(boxes, np.float32).reshape(-1, 4),
            }
            if self._include_difficult_flags:
                sample["difficult"] = np.array(difficult, bool)
            yield sample
