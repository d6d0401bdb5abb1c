"""COCO loader (a copy of ``retinanet_tpu/data/loaders/coco.py``).

The reference uses pycocotools; for iteration + box extraction plain
``json`` is all that's needed.  Same
behaviour: category ids sorted and re-indexed densely, crowd annotations and
degenerate (sub-pixel) boxes skipped, images without annotations skipped,
boxes converted from COCO ``[left, top, w, h]`` to ``[t, l, b, r]`` pixels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np

from retinanet_tpu_torch.data.loaders.base import Base


class COCO(Base):
    """``include_crowds=False`` (default) mirrors the reference's training
    behaviour (crowds dropped, ``getAnnIds(iscrowd=False)`` coco.py:33).
    ``include_crowds=True`` is the *evaluation* mode: crowd annotations are
    kept and every sample carries ``iscrowd`` and ``areas`` arrays so the
    COCO eval protocol can treat crowds as ignore regions and use the
    annotation's segmentation ``area`` (what COCOeval's area-range ignores
    actually read) instead of the bbox area.  Eval mode also yields
    annotation-free images (empty arrays): pycocotools evaluates every
    image in ``ann['images']``, and detections on empty images must count
    as false positives — skipping them (the training behaviour) would
    inflate mAP."""

    def __init__(self, ann_path: str, dataset_path: str,
                 include_crowds: bool = False):
        with open(ann_path) as f:
            ann = json.load(f)
        self._dataset_path = dataset_path
        self._include_crowds = include_crowds
        self._category_ids = sorted(c["id"] for c in ann["categories"])
        self._cat_index = {cid: i for i, cid in enumerate(self._category_ids)}
        cat_by_id = {c["id"]: c for c in ann["categories"]}
        self._class_names = [cat_by_id[cid]["name"]
                             for cid in self._category_ids]

        self._images = ann["images"]
        self._anns_by_image: Dict[int, List[dict]] = {}
        for a in ann["annotations"]:
            if a.get("iscrowd", 0) and not include_crowds:
                continue  # reference: getAnnIds(iscrowd=False) coco.py:33
            self._anns_by_image.setdefault(a["image_id"], []).append(a)

    @property
    def class_names(self) -> List[str]:
        return list(self._class_names)

    def _image_has_valid_box(self, image_id: int) -> bool:
        return any(a["bbox"][2] >= 1 and a["bbox"][3] >= 1
                   for a in self._anns_by_image.get(image_id, []))

    def __len__(self) -> int:
        # Must agree exactly with __iter__ (a mismatch desynchronizes the
        # multi-host per-epoch step cap): images whose only annotations are
        # degenerate (sub-pixel) boxes are skipped by iteration too.
        if self._include_crowds:
            return len(self._images)
        return sum(1 for im in self._images
                   if self._image_has_valid_box(im["id"]))

    def __iter__(self) -> Iterator[Dict]:
        for image in self._images:
            annotations = self._anns_by_image.get(image["id"], [])
            boxes, class_ids, iscrowd, areas = [], [], [], []
            for a in annotations:
                left, top, width, height = a["bbox"]
                if height < 1 or width < 1:  # reference coco.py:42-44
                    continue
                boxes.append([top, left, top + height, left + width])
                class_ids.append(self._cat_index[a["category_id"]])
                iscrowd.append(bool(a.get("iscrowd", 0)))
                areas.append(float(a.get("area", width * height)))
            if not boxes and not self._include_crowds:
                continue  # reference skips images without boxes coco.py:55
            sample = {
                "image_file": os.path.join(self._dataset_path,
                                           image["file_name"]),
                "class_ids": np.array(class_ids, np.int32),
                "boxes": np.array(boxes, np.float32).reshape(-1, 4),
            }
            if self._include_crowds:
                sample["iscrowd"] = np.array(iscrowd, bool)
                sample["areas"] = np.array(areas, np.float32)
                # Original COCO image id: lets evaluate --dump-detections
                # emit results keyed the way pycocotools expects.
                sample["image_id"] = image["id"]
            yield sample

    @property
    def coco_category_ids(self):
        """Contiguous class index -> original COCO category id (for
        exporting detections in canonical COCO-results format)."""
        return list(self._category_ids)
