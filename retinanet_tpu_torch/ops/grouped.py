"""Grouped convolution kernels as dense ones.

``block_diagonal`` is shared by the float ``Conv`` (which runs a grouped
conv of input width F ≤ 512 as its dense form, the JAX module's rule) and
kernel B6's weight layout (``int8_conv.prepare_weights``), which always
takes the dense form.
"""

from __future__ import annotations

import torch
from torch import Tensor


def block_diagonal(kernel: Tensor, groups: int) -> Tensor:
    """The dense OIHW kernel ``[F, C, kh, kw]`` of a grouped one ``[F,
    C/g, kh, kw]``: output channel o reads input channel i through
    ``kernel[o, i % (C/g)]`` where both lie in the same group, and zero
    elsewhere.  Differentiable; works for any dtype (int8 included)."""
    f, cg = kernel.shape[:2]
    c, fg = cg * groups, f // groups
    mask = (torch.arange(f, device=kernel.device)[:, None] // fg
            == torch.arange(c, device=kernel.device)[None, :] // cg)
    return kernel.repeat(1, groups, 1, 1) * mask.to(kernel.dtype)[:, :, None,
                                                                  None]
