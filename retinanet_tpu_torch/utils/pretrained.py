"""Backbone weight import/export (a copy of
``retinanet_tpu/utils/pretrained.py``, the ``train --init-backbone``
hook), on the port's state_dicts.

  * ``save_backbone`` / ``load_backbone``: npz round-trip of just the
    backbone subtree, keyed by flax leaf path below ``backbone_net`` (the
    JAX package's files, read and written the same way)
  * ``import_flat_weights``: map an arbitrary flat ``{name: array}`` dict
    (e.g. converted from torch/TF) onto the backbone's parameters by
    name, then by shape-compatible greedy matching in order, with a report
    of what matched
  * ``convert_torch_layout`` / ``convert_tf_layout``: memory-layout
    conversion of foreign checkpoints into flax's (torch OIHW → HWIO,
    torch linear [O,I] → [I,O], TF depthwise [H,W,C,M] → [H,W,1,C·M], BN
    running stats dropped)
  * ``convert_torchvision_resnet50``: exact name mapping from a
    torchvision ``resnet50`` state_dict onto the dense ResNet-50's flax
    leaf paths (BN γ/β → GroupNorm γ/β; the block's projection is
    ``ConvGN_0``, where torchvision puts ``downsample`` after ``conv3``).

The matcher works where the JAX module works: on the flat flax-path-keyed
float32 arrays (HWIO kernels) of ``export.flax_from_params``, whose order
is JAX's tree-flattening order (keys sorted level by level).  That order
decides which of several same-shaped sources lands where, so it has to be
the same.  Results go back through ``export.params_from_flax``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
from torch import Tensor

from retinanet_tpu_torch.export import flax_from_params, params_from_flax

_SUBTREE = "backbone_net"


def _subtree(flat: Mapping[str, np.ndarray], subtree: str
             ) -> List[Tuple[str, np.ndarray]]:
    """The leaves under ``subtree``, named relative to it, in order."""
    prefix = subtree + "/"
    return [(k[len(prefix):], v) for k, v in flat.items()
            if k.startswith(prefix)]


def _replace(params: Mapping[str, Tensor], flat: Dict[str, np.ndarray],
             subtree: str, leaves: Mapping[str, np.ndarray]
             ) -> Dict[str, Tensor]:
    """A new state_dict, sharing no storage with ``params`` or ``leaves``:
    ``params`` with the subtree's leaves replaced."""
    flat = dict(flat)
    for name, value in leaves.items():
        flat[f"{subtree}/{name}"] = value
    return params_from_flax({k: np.array(v, np.float32)
                             for k, v in flat.items()})


def save_backbone(params: Mapping[str, Tensor], path: str) -> None:
    """Save the ``backbone_net`` parameters as an npz archive."""
    np.savez(path, **dict(_subtree(flax_from_params(params), _SUBTREE)))


def load_backbone(params: Mapping[str, Tensor], path: str
                  ) -> Dict[str, Tensor]:
    """Restore a ``save_backbone`` archive into a matching state_dict.

    Returns a new state_dict with the backbone replaced; raises if a
    stored array's name or shape doesn't match.
    """
    flat = flax_from_params(params)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    leaves = {}
    for name, leaf in _subtree(flat, _SUBTREE):
        if name not in stored:
            raise KeyError(f"checkpoint missing backbone param {name}")
        arr = stored[name]
        if arr.shape != leaf.shape:
            raise ValueError(
                f"shape mismatch for {name}: {arr.shape} vs {leaf.shape}")
        leaves[name] = arr
    return _replace(params, flat, _SUBTREE, leaves)


def convert_torch_layout(weights: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """torch → flax memory-layout conversion (names preserved).

    * conv kernels [O, I/g, kH, kW] → HWIO [kH, kW, I/g, O] (covers
      depthwise [C, 1, kH, kW] → [kH, kW, 1, C] too)
    * linear ``*.weight`` [O, I] → [I, O]
    * BatchNorm ``running_mean`` / ``running_var`` / ``num_batches_tracked``
      dropped — GroupNorm has no running statistics, and their [C] shapes
      would otherwise collide with γ/β in shape matching
    """
    out = {}
    for name, arr in weights.items():
        base = name.rsplit(".", 1)[-1]
        if base in ("running_mean", "running_var", "num_batches_tracked"):
            continue
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2 and base == "weight":
            arr = arr.T
        out[name] = arr
    return out


def convert_tf_layout(weights: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """TF/TF-slim → flax layout conversion (names preserved).

    TF conv kernels are already HWIO; depthwise kernels
    [H, W, C, multiplier] become the ``feature_group_count`` form
    [H, W, 1, C·multiplier].  BN moving statistics are dropped (GroupNorm
    backbone has none).
    """
    out = {}
    for name, arr in weights.items():
        low = name.lower()
        if "moving_mean" in low or "moving_variance" in low:
            continue
        arr = np.asarray(arr)
        if arr.ndim == 4 and "depthwise" in low:
            h, w, c, m = arr.shape
            arr = arr.reshape(h, w, 1, c * m)
        out[name] = arr
    return out


#: torchvision resnet50 stage depths (layer1..layer4).
_RESNET50_DEPTHS = (3, 4, 6, 3)


def convert_torchvision_resnet50(state_dict: Dict[str, np.ndarray]
                                 ) -> Dict[str, np.ndarray]:
    """Map a torchvision ``resnet50`` state_dict onto the exact flax leaf
    paths of the dense ResNet-50 below ``backbone_net`` (OIHW → HWIO on the
    way; BN γ/β land on GroupNorm γ/β; ``fc.*`` and running stats are
    dropped — the backbone has no classifier).

    The result feeds :func:`import_flat_weights`, where every entry matches
    **by name** (pass 1), so repeated same-shape layers can never
    cross-wire.
    """
    sd = state_dict
    out: Dict[str, np.ndarray] = {}

    def put(prefix: str, conv_w, bn_w, bn_b) -> None:
        out[f"{prefix}/Conv_0/kernel"] = \
            np.asarray(conv_w).transpose(2, 3, 1, 0)
        out[f"{prefix}/GroupNorm_0/gamma"] = np.asarray(bn_w)
        out[f"{prefix}/GroupNorm_0/beta"] = np.asarray(bn_b)

    put("ConvGN_0", sd["conv1.weight"], sd["bn1.weight"], sd["bn1.bias"])
    idx = 0
    for layer, depth in enumerate(_RESNET50_DEPTHS, start=1):
        for b in range(depth):
            src = f"layer{layer}.{b}"
            dst = f"ResNetBottleneck_{idx}"
            # The block creates the projection FIRST, so in projected
            # blocks conv1..3 are ConvGN_1..3; otherwise ConvGN_0..2.
            has_proj = f"{src}.downsample.0.weight" in sd
            if has_proj:
                put(f"{dst}/ConvGN_0", sd[f"{src}.downsample.0.weight"],
                    sd[f"{src}.downsample.1.weight"],
                    sd[f"{src}.downsample.1.bias"])
            off = 1 if has_proj else 0
            for k in (1, 2, 3):
                put(f"{dst}/ConvGN_{k - 1 + off}", sd[f"{src}.conv{k}.weight"],
                    sd[f"{src}.bn{k}.weight"], sd[f"{src}.bn{k}.bias"])
            idx += 1
    return out


def _natural_key(name: str):
    """Numeric-aware sort key: ``Conv_2`` < ``Conv_10`` (plain lexicographic
    order — the flattening order — sorts ``Conv_10`` first, which silently
    cross-wires repeated same-shape layers)."""
    import re
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", name)]


def _name_tokens(name: str) -> tuple:
    """Separator/case-insensitive token sequence for name matching
    (``layer1.0.conv1.weight`` ≡ ``layer1/0/conv1/weight``)."""
    import re
    return tuple(t for t in re.split(r"[^0-9a-zA-Z]+", name.lower()) if t)


def import_flat_weights(params: Mapping[str, Tensor],
                        weights: Dict[str, np.ndarray],
                        subtree: str = _SUBTREE):
    """Name-aware import of foreign weights (torch/TF converts) onto the
    target subtree.  Two passes:

    1. **by name**: targets whose normalized token sequence (case/separator
       insensitive) equals a source name's, with matching shape;
    2. **by shape, order-preserving**: remaining targets in *natural* name
       order (``Conv_2`` before ``Conv_10``) are paired with remaining
       sources of the same shape in source insertion order, i-th to i-th.

    Returns ``(new_params, report)``; report lists name/shape matches,
    unmatched targets, and unused sources — callers should check it.
    """
    flat = flax_from_params(params)
    named = _subtree(flat, subtree)

    used: set = set()
    assigned: Dict[str, str] = {}
    by_name, by_shape = [], []

    # Pass 1: exact normalized-name matches.
    src_by_tokens: Dict[tuple, List[str]] = {}
    for src_name in weights:
        src_by_tokens.setdefault(_name_tokens(src_name), []).append(src_name)
    for tname, leaf in named:
        for src_name in src_by_tokens.get(_name_tokens(tname), []):
            if src_name not in used and \
                    tuple(weights[src_name].shape) == tuple(leaf.shape):
                assigned[tname] = src_name
                used.add(src_name)
                by_name.append((tname, src_name))
                break

    # Pass 2: per-shape order-preserving pairing, targets in natural order.
    from collections import deque
    src_queues: Dict[tuple, deque] = {}
    for src_name, arr in weights.items():  # insertion order = layer order
        if src_name not in used:
            src_queues.setdefault(tuple(arr.shape), deque()).append(src_name)
    for tname, leaf in sorted(
            ((n, l) for n, l in named if n not in assigned),
            key=lambda kv: _natural_key(kv[0])):
        queue = src_queues.get(tuple(leaf.shape))
        if queue:
            src_name = queue.popleft()
            assigned[tname] = src_name
            used.add(src_name)
            by_shape.append((tname, src_name))

    unmatched = [n for n, _ in named if n not in assigned]
    new_params = _replace(params, flat, subtree,
                          {name: weights[src] for name, src in
                           assigned.items()})
    report = {"matched": by_name + by_shape,
              "matched_by_name": by_name,
              "matched_by_shape": by_shape,
              "unmatched": unmatched,
              "unused_sources": [k for k in weights if k not in used]}
    return new_params, report


def load_pretrained(params: Mapping[str, Tensor], path: str,
                    backbone: str = ""):
    """``train --init-backbone PATH`` entry: initialize the backbone
    from a foreign or native checkpoint file, dispatching on content.

    * ``.npz`` whose names exactly cover the backbone (a
      :func:`save_backbone` artifact) → :func:`load_backbone`;
    * ``.npz`` with foreign flat names → layout-convert then
      :func:`import_flat_weights` (torchvision-resnet50 name mapping when
      the names look like one and the model is the dense ResNet50; generic
      torch OIHW conversion otherwise);
    * ``.pt``/``.pth`` → ``torch.load(weights_only=True)`` state_dict,
      then as above.

    Raises if any backbone parameter ends up unmatched — a silent partial
    init is a training-quality landmine.  Returns ``(new_params, report)``
    (report is ``None`` for the exact-name npz path, which is all-or-error
    by construction).
    """
    if path.endswith((".pt", ".pth")):
        import torch
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        weights = {k: np.asarray(v) for k, v in sd.items()}
    else:
        with np.load(path) as data:
            weights = {k: data[k] for k in data.files}
        try:  # exact save_backbone round-trip?
            return load_backbone(params, path), None
        except (KeyError, ValueError):
            pass  # foreign names — fall through to conversion

    looks_torchvision = "layer1.0.conv1.weight" in weights
    if looks_torchvision and backbone == "resnet_50_dense":
        try:
            converted = convert_torchvision_resnet50(weights)
        except KeyError as e:
            raise ValueError(
                f"--init-backbone archive looks like a torchvision resnet50 "
                f"state_dict but is missing {e}; refusing a partial init")
    elif any(k.endswith(".weight") for k in weights):
        converted = convert_torch_layout(weights)
    else:
        converted = weights
    new_params, report = import_flat_weights(params, converted)
    if report["unmatched"]:
        raise ValueError(
            f"--init-backbone left {len(report['unmatched'])} backbone "
            f"params uninitialized (first: {report['unmatched'][:3]}); "
            f"refusing a partial init")
    return new_params, report
