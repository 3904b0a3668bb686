"""Data pipeline: deterministic batching for training, a numpy copy of
``repro.data.pipeline.BatchIterator`` (one seed gives both packages the
same batches).

The batches stay numpy arrays on the host; a caller moves one to its
device with ``torch.as_tensor(..., device=)``. Placing a batch across a
mesh of devices (JAX's ``shard_batch``) comes with the port's mesh slice
(ROADMAP.md, queue A, item 8).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchIterator:
    """Infinite shuffled epochs over an array dict, fixed batch size."""

    def __init__(self, data: dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, drop_remainder: bool = True):
        n = len(next(iter(data.values())))
        if any(len(v) != n for v in data.values()):
            raise ValueError("every array needs the same number of rows")
        if not drop_remainder:
            raise ValueError("only drop_remainder=True is supported")
        self.data, self.n, self.bs = data, n, batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            order = self.rng.permutation(self.n)
            for i in range(0, self.n - self.bs + 1, self.bs):
                idx = order[i:i + self.bs]
                yield {k: v[idx] for k, v in self.data.items()}
