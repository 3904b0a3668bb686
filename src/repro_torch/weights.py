"""Carry a JAX parameter pytree, and an optimizer state, into the port.

``params_from_jax`` takes the JAX params as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the caller's side) and returns the
same tree — the same dicts and lists, stacked ``[L, ...]`` blocks, dense
weights ``[d_in, d_out]`` — as torch tensors on ``device``. Both packages
then compute the same function on the same weights.

``np.asarray`` of a JAX bfloat16 array has the ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` refuses; those leaves go through their
16-bit pattern (``view(np.uint16)`` → ``view(torch.bfloat16)``), which is
exact.

``opt_state_from_jax`` carries the state of ``repro.train.optimizer``
(``{"m", "v", "step"}``, fp32 moments and an int32 step) the same way,
with the step as the Python int the port's optimizer counts with, so a
JAX ``(params, opt_state)`` pair trains on in the port.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


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


# subtrees JAX keeps in fp32 whatever the model's dtype: the MoE router
# (``repro.models.moe.moe_params``); a recast leaves them as they are
KEEP_DTYPE = ("router",)


def params_from_jax(tree: Any, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> Any:
    """Numpy pytree -> the same pytree of torch tensors on ``device``;
    ``dtype`` (if given) recasts the floating-point leaves, except those
    under a key of ``KEEP_DTYPE``."""
    dev = resolve_device(device)

    def walk(t: Any, dt: torch.dtype | None) -> Any:
        if isinstance(t, dict):
            return {k: walk(v, None if k in KEEP_DTYPE else dt)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, dt) for v in t)
        return _leaf_to_torch(t, dev, dt)

    return walk(tree, dtype)


def opt_state_from_jax(state: Any, device: str | torch.device = "cuda"
                       ) -> dict:
    """Numpy AdamW state {"m", "v", "step"} -> the port's, on
    ``device``."""
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device),
            "step": int(np.asarray(state["step"]))}
