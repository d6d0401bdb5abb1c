"""The weight bridge: JAX export files and seeded random weights, and the
``export`` CLI, which writes an experiment's checkpoint as one file:

    python -m retinanet_tpu_torch.export --experiment E \
        --backbone resnet_50_dense --scale 640 \
        --class-names square,triangle,circle --out model.npz

Both ``params_from_flax`` (JAX parameters) and ``init_params`` (seeded
weights) give a ``state_dict`` that serves through ``infer.Detector`` and
starts training through ``train.create_train_state``; ``export_model``
writes a ``state_dict`` back as an export file that either package serves
(``load_exported_detector`` here, ``load_exported`` in the JAX package).

Parameters cross from the JAX package through its export format
(``retinanet_tpu/export.py:export_model``, the ``retinanet_tpu_export_v1``
npz keyed by flax leaf path).  The port's modules carry flax's names, so a
leaf path maps onto a ``state_dict`` key by replacing ``/`` with ``.``;
conv kernels turn from HWIO to OIHW.  Reading needs numpy alone: bf16
leaves are stored as their uint16 bit patterns and viewed back as torch
bf16.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.models.layers import Conv, GroupNorm
from retinanet_tpu_torch.models.retinanet import RetinaNet

EXPORT_FORMAT = "retinanet_tpu_export_v1"
_META_KEY = "__retinanet_tpu_meta__"


def _to_tensor(value: Union[np.ndarray, Tensor]) -> Tensor:
    return value if isinstance(value, Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))


def params_from_flax(flat: Mapping[str, Union[np.ndarray, Tensor]]
                     ) -> Dict[str, Tensor]:
    """Flat flax params ``{'a/b/kernel': HWIO array}`` → port state_dict
    ``{'a.b.kernel': OIHW tensor}``; other leaves keep their shape."""
    state = {}
    for path, value in flat.items():
        t = _to_tensor(value)
        if path.rsplit("/", 1)[-1] == "kernel":
            t = t.permute(3, 2, 0, 1)
        state[path.replace("/", ".")] = t.contiguous()
    return state


def flax_from_params(state_dict: Mapping[str, Tensor]
                     ) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_flax``: port state_dict → flat flax
    params ``{'a/b/kernel': HWIO float32 array}``, in the order of JAX's
    pytree flattening (keys sorted level by level)."""
    flat = {}
    for key in sorted(state_dict, key=lambda k: k.split(".")):
        t = state_dict[key].detach().to("cpu", torch.float32)
        if key.rsplit(".", 1)[-1] == "kernel":
            t = t.permute(2, 3, 1, 0)
        flat[key.replace(".", "/")] = t.contiguous().numpy()
    return flat


def export_model(state_dict: Mapping[str, Tensor], class_names: List[str],
                 backbone: str, image_size: int, path: str,
                 dtype: str = "float32") -> int:
    """Write params + metadata as one ``retinanet_tpu_export_v1`` npz (the
    JAX package's ``export_model``, from a port state_dict); returns the
    leaf count.

    ``dtype="bfloat16"`` stores the float leaves as bf16 bit patterns
    (uint16, rounded to nearest even as ``ml_dtypes`` rounds) and lists
    them in the meta's ``bf16_leaves``; loading restores float32.  The
    file always lands at a ``.npz`` path.
    """
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown export dtype {dtype!r}")
    if not path.endswith(".npz"):
        path += ".npz"
    arrays: Dict[str, np.ndarray] = {}
    bf16_leaves: List[str] = []
    for name, value in flax_from_params(state_dict).items():
        if dtype == "bfloat16":
            bf16_leaves.append(name)
            value = torch.from_numpy(value).to(torch.bfloat16).view(
                torch.int16).numpy().view(np.uint16)
        arrays[name] = value
    meta = {"format": EXPORT_FORMAT,
            "backbone": backbone,
            "image_size": int(image_size),
            "dtype": dtype,
            "bf16_leaves": bf16_leaves,
            "class_names": list(class_names)}
    count = len(arrays)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    return count


def read_meta(path: str) -> dict:
    with np.load(path) as data:
        if _META_KEY not in data:
            raise ValueError(f"{path} is not a retinanet_tpu export "
                             f"(missing {_META_KEY})")
        meta = json.loads(bytes(data[_META_KEY]).decode())
    if meta.get("format") != EXPORT_FORMAT:
        raise ValueError(f"{path}: unknown export format {meta.get('format')}")
    return meta


def load_exported(path: str) -> Tuple[dict, Dict[str, Tensor], List[str],
                                      int]:
    """→ (meta, state_dict, class_names, image_size).

    bf16-stored leaves come back as float32 (exact), as in the JAX loader.
    """
    meta = read_meta(path)
    bf16_leaves = set(meta.get("bf16_leaves", ()))
    flat = {}
    with np.load(path) as data:
        for name in data.files:
            if name == _META_KEY:
                continue
            arr = data[name]
            if name in bf16_leaves:
                flat[name] = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16).float()
            else:
                flat[name] = torch.from_numpy(arr)
    return (meta, params_from_flax(flat), list(meta["class_names"]),
            int(meta["image_size"]))


def init_params(config: Config, generator: torch.Generator,
                num_classes: int = None) -> Dict[str, Tensor]:
    """Seeded random weights with flax's distributions: He-normal fan-in
    kernels in the backbone, N(0, 0.01) in the FPN and heads, GN γ=1 and
    β=0, and the class-output bias at the π prior."""
    levels = build_levels(config.anchors)
    model = RetinaNet.from_config(config.model, levels.num_anchors,
                                  num_classes)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                o, i, kh, kw = module.kernel.shape
                std = (math.sqrt(2.0 / (i * kh * kw))
                       if module.kernel_init == "he_normal" else 0.01)
                module.kernel.normal_(0.0, std, generator=generator)
                if module.bias is not None:
                    module.bias.fill_(module.bias_init)
            elif isinstance(module, GroupNorm):
                module.gamma.fill_(1.0)
                module.beta.fill_(0.0)
    return model.state_dict()


def load_exported_detector(path: str, config: Optional[Config] = None,
                           device: Union[str, torch.device] = "cuda",
                           devices: Optional[Sequence] = None):
    """A ready ``infer.Detector`` from an export file, on the card unless
    the caller passes another device, or data-parallel over ``devices``.
    ``config`` (optional) sets the serving knobs (NMS thresholds, batch
    size, quantize, fused blocks); backbone and classes always come from
    the export."""
    from retinanet_tpu_torch.infer import Detector  # infer imports this
    return Detector.from_export(path, config=config, device=device,
                                devices=devices)


def main(argv=None):
    """``python -m retinanet_tpu_torch.export``: the JAX CLI's flags, with
    ``--device`` (where ``load_detector`` builds the model; the card unless
    it says otherwise) in place of ``--platform``."""
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="export a checkpoint as a single-file serving artifact")
    parser.add_argument("--experiment", type=str, required=True)
    parser.add_argument("--backbone", type=str, default="resnet_50")
    parser.add_argument("--scale", type=int, default=600,
                        help="serving canvas size recorded in the artifact")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument(
        "--class-names", type=str, default=None,
        help="comma-separated class names (order = training class ids)")
    parser.add_argument(
        "--dataset", type=str, nargs="+", default=None,
        help="alternative to --class-names: take names from a dataset spec")
    parser.add_argument("--out", type=str, required=True, metavar="PATH.npz")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="storage dtype for float params (bfloat16 "
                             "halves the artifact size; serving computes "
                             "in bf16 regardless)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to load the model on (default "
                             "cuda)")
    args = parser.parse_args(argv)

    from retinanet_tpu_torch.config import _apply_dotted
    from retinanet_tpu_torch.detect import _Names, _resolve_class_names
    from retinanet_tpu_torch.evaluate import load_detector

    class_names = _resolve_class_names(args)
    config = Config()
    for dotted, value in [
        ("data.image_size", args.scale),
        ("model.backbone", args.backbone),
        ("train.experiment", args.experiment),
    ]:
        config = _apply_dotted(config, dotted, value)
    detector = load_detector(config, _Names(class_names), args.step,
                             device=args.device)
    return export_model(detector.model.state_dict(), class_names,
                        args.backbone, args.scale, args.out,
                        dtype=args.dtype)


if __name__ == "__main__":
    main()
