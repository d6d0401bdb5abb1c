"""Small CLI utilities (a copy of ``retinanet_tpu/utils/cli.py:log_args``,
the reference ``utils.py:16-19`` colored arg echo).

The JAX module's ``enable_compilation_cache`` sets XLA's persistent
compilation cache and has no counterpart here; nor has ``force_platform``:
the port's CLIs take ``--device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def log_args(args: Any) -> None:
    """Colored echo of parsed arguments / config (reference ``log_args``).

    Accepts an argparse.Namespace or any dataclass; falls back to plain
    print when termcolor is unavailable.
    """
    try:
        from termcolor import colored
    except ImportError:  # pragma: no cover
        colored = lambda s, _c: s  # noqa: E731

    if dataclasses.is_dataclass(args):
        items = dataclasses.asdict(args).items()
    else:
        items = vars(args).items()
    print(colored("arguments:", "yellow"))
    for key, value in sorted(items):
        print(colored(f"\t{key}:", "yellow"), value)
