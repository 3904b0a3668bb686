"""Carry a JAX parameter pytree into the port.

``params_from_jax`` takes the JAX params as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the caller's side) and returns the
same tree — the same dicts and lists, stacked ``[L, ...]`` blocks, dense
weights ``[d_in, d_out]`` — as torch tensors on ``device``. Both packages
then compute the same function on the same weights.

``np.asarray`` of a JAX bfloat16 array has the ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` refuses; those leaves go through their
16-bit pattern (``view(np.uint16)`` → ``view(torch.bfloat16)``), which is
exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _leaf_to_torch(a: Any, device: torch.device,
                   dtype: torch.dtype | None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> Any:
    """Numpy pytree -> the same pytree of torch tensors on ``device``;
    ``dtype`` (if given) recasts the floating-point leaves."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev, dtype), tree)
