"""Checkpointing: msgpack-serialised parameter / optimizer-state trees,
in the payload of ``repro.train.checkpoint`` (a file either package writes
loads in the other, bit for bit).

The payload is ``{"step", "treedef", "leaves": [{"dtype", "shape",
"data"}]}`` with the leaves in ``jax.tree.flatten`` order (dict keys
sorted) and their raw bytes; bfloat16 leaves are stored as their uint16
bits. A Python int leaf (the port's optimizer step) is stored as the
int32 scalar JAX's ``init_opt_state`` keeps, and loads back as an int.
Writes go to a temporary file that replaces the target (atomic).
"""

from __future__ import annotations

import os
from typing import Any

import msgpack
import numpy as np
import torch

from repro_torch.tree import jax_leaves, jax_treedef, jax_unflatten

def _pack_leaf(x) -> dict:
    if isinstance(x, int):
        a = np.asarray(x, np.int32)
    elif x.dtype == torch.bfloat16:
        bits = x.detach().cpu().contiguous().view(torch.int16).numpy()
        return {"dtype": "bfloat16", "shape": list(x.shape),
                "data": bits.view(np.uint16).tobytes()}
    else:
        a = x.detach().cpu().contiguous().numpy()
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_leaf(d: dict, like):
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(d["data"], np.uint16).view(np.int16)
        t = torch.from_numpy(a.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(d["data"], d["dtype"]).copy())
    t = t.reshape(d["shape"])
    if isinstance(like, int):
        return int(t)
    return t.to(like.device)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    payload = {"step": step,
               "treedef": jax_treedef(tree),
               "leaves": [_pack_leaf(x) for x in jax_leaves(tree)]}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    os.replace(tmp, path)  # atomic


def load_checkpoint(path: str, like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (leaf count and shapes
    checked), each tensor on its ``like`` leaf's device. Returns (tree,
    step)."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    likes = jax_leaves(like)
    if len(payload["leaves"]) != len(likes):
        raise ValueError(f"checkpoint has {len(payload['leaves'])} leaves, "
                         f"the tree {len(likes)}")
    restored = []
    for d, ref in zip(payload["leaves"], likes):
        want = [] if isinstance(ref, int) else list(ref.shape)
        if list(d["shape"]) != want:
            raise ValueError(f"checkpoint leaf shape {d['shape']} != "
                             f"{want}")
        restored.append(_unpack_leaf(d, ref))
    return jax_unflatten(like, restored), payload["step"]
