"""The remote model's weights, drawn on the device from the run's seed.

The layout is the one its family module gives (``reference/<family>.py``
``leaves``: the port's parameter tree). Every leaf is a view into ONE
buffer that a single ``torch.randn`` fills in the served dtype, so the
draw is one large call on the card; each view is then scaled in place:
dense weights by their ``leaves`` scale (1 / sqrt(d_in)), the embedding
by 0.02, norms to 1 + 0.1 N(0, 1) and biases to 0.1 N(0, 1), so that no
weight of the served path is a constant. The same seed and widths give
the same bits.
"""

from __future__ import annotations

import math

import torch

from cascade_bench.reference import family

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def draw(config: dict, seed: int, device) -> dict:
    """The weights of ``config`` (a ``configs/*.json`` dict) for ``seed``,
    on ``device``, in the config's dtype."""
    fam = family(config)
    w = fam.widths(config)
    device = torch.device(device)
    leaves = fam.leaves(w)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=DTYPES[w["dtype"]])
    params: dict = {}
    off = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if scale == "norm":
            leaf.mul_(0.1).add_(1.0)
        elif scale == "bias":
            leaf.mul_(0.1)
        else:
            leaf.mul_(scale)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params
