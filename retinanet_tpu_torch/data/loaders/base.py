"""Abstract loader interface (a copy of ``retinanet_tpu/data/loaders/base.py``).

A loader iterates over sample dicts:
  * ``image_file``: str path (or ``image``: HWC uint8 array for in-memory
    datasets — the pipeline accepts either)
  * ``class_ids``: [N] int array
  * ``boxes``: [N, 4] float array, (t, l, b, r) in **pixels**
"""

from __future__ import annotations

from typing import Dict, Iterator, List


class Base:
    @property
    def class_names(self) -> List[str]:
        raise NotImplementedError

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __iter__(self) -> Iterator[Dict]:
        raise NotImplementedError

    def __len__(self) -> int:
        """Number of samples, if known (used for steps-per-epoch)."""
        raise NotImplementedError
