"""Loader dispatcher + validity checks
(a copy of ``retinanet_tpu/data/loaders/inferred.py``).

``Inferred('shapes', ['/tmp/x', '10', '600'])`` etc. — the same stringly CLI
contract as the reference, with per-sample validation that every sample has
≥1 box and all boxes satisfy tl < br.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from retinanet_tpu_torch.data.loaders.base import Base


class Inferred(Base):
    def __init__(self, type: str, args: Sequence[str],
                 include_crowds: bool = False):
        """``include_crowds`` is the COCO evaluation mode (crowd GTs kept as
        ignore regions with ``iscrowd``/``areas`` arrays); loaders without a
        crowd concept ignore it."""
        self._allow_empty = include_crowds  # eval mode: empty images are
        # legitimate FP sources (pycocotools evaluates every image)
        if type == "coco":
            from retinanet_tpu_torch.data.loaders.coco import COCO
            self._dl = COCO(*args, include_crowds=include_crowds)
        elif type == "pascal":
            from retinanet_tpu_torch.data.loaders.pascal import Pascal
            # Eval mode (include_crowds) is VOC's difficult-flags mode:
            # both mark protocol-level ignore annotations.
            self._dl = Pascal(*args, include_difficult_flags=include_crowds)
        elif type == "shapes":
            from retinanet_tpu_torch.data.loaders.shapes import Shapes
            self._dl = Shapes(args[0], int(args[1]),
                              (int(args[2]), int(args[2])))
        else:
            raise ValueError(f"unknown dataset type: {type}")

    @property
    def class_names(self) -> List[str]:
        return self._dl.class_names

    @property
    def coco_category_ids(self):
        """Original COCO category ids (contiguous-index order) when the
        wrapped loader knows them; None otherwise.  Forwarded so
        ``evaluate --dump-detections`` emits canonical category ids."""
        return getattr(self._dl, "coco_category_ids", None)

    def __len__(self) -> int:
        return len(self._dl)

    def __iter__(self) -> Iterator[Dict]:
        for x in self._dl:
            # Reference inferred.py:30-32 asserts; raise with context instead.
            if x["boxes"].shape[0] != x["class_ids"].shape[0] or \
                    (x["boxes"].shape[0] == 0 and not self._allow_empty):
                raise ValueError(f"sample has invalid box/class counts: {x}")
            tl, br = np.split(x["boxes"], 2, -1)
            if not np.all(tl < br):
                raise ValueError(f"degenerate box (tl >= br) in sample: "
                                 f"{x['boxes']}")
            yield x
