"""Dataset statistics CLI (a copy of ``retinanet_tpu/data/stats.py``; the
reference ``dataset.py:236-277`` ``__main__`` —
which is broken there: stale ``build_dataset`` signature at
``dataset.py:241``).  Computes channel mean/std over a dataset; the values
baked into ``DataConfig.mean/std`` came from a run of the reference's
equivalent.

Usage: ``python -m retinanet_tpu_torch.data.stats --dataset shapes /tmp/x 100 256``
"""

from __future__ import annotations

import argparse
import json

from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.data.pipeline import compute_mean_std


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, nargs="+", required=True)
    parser.add_argument("--max-samples", type=int, default=None)
    args = parser.parse_args(argv)

    loader = Inferred(args.dataset[0], args.dataset[1:])
    mean, std = compute_mean_std(loader, max_samples=args.max_samples)
    print(json.dumps({"mean": mean.tolist(), "std": std.tolist()}))


if __name__ == "__main__":
    main()
