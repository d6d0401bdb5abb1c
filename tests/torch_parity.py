"""Shared helpers of the ``test_torch_*`` parity tests: seeded numpy
parameters for the flagship, handed to the JAX package as a flax pytree and
to the port as a state_dict, so both run on the same weights.

Parameters come from ``jax.eval_shape`` (shapes only) plus numpy, not from
``model.init``, which runs the whole model eagerly on the CPU.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from retinanet_tpu.config import ModelConfig
from retinanet_tpu.export import _leaf_path
from retinanet_tpu.models.retinanet import RetinaNet


def flagship_config(num_classes: int = 4, compute_dtype: str = "float32",
                    **kw) -> ModelConfig:
    return ModelConfig(backbone="resnet_50_dense", num_classes=num_classes,
                       compute_dtype=compute_dtype, **kw)


def random_flat_params(cfg: ModelConfig, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """Flat ``{leaf path: float32 array}`` of the JAX model's parameters:
    He-normal kernels, γ≈1 and β≈0 with noise, small biases.  Every kernel
    is He-scaled (the FPN/head init of N(0, 0.01) would leave the outputs
    at the bias and test little)."""
    model = RetinaNet.from_config(cfg, 9, cfg.num_classes)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3)), training=False)
    )["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = _leaf_path(path)
        shape = leaf.shape
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:  # beta, bias
            v = 0.1 * rng.randn(*shape)
        flat[name] = v.astype(np.float32)
    return flat


def to_flax(flat: Dict[str, np.ndarray]):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
