"""Content-keyed remote-response cache (runtime control plane, DESIGN.md §4).

Escalating the same input twice must not be billed twice: remote tiers are
metered per request (CheapET-3 frames the remote model as a billed service),
so the runtime keys every escalated request by the *content* of its
remote-tier input and serves duplicates from an LRU cache. Hit/miss counts
are folded into the engine's `CascadeStats` so the cost model only bills
genuine remote invocations.

Keys are content hashes over the request pytree (arrays hashed with their
dtype/shape so `[1, 2]` int32 and `[1, 2]` float32 never collide).

With a multi-remote registry (DESIGN.md §6) every entry also remembers the
*source* — the name of the backend that filled it — so a cache hit
attributes to the right backend in the engine's per-backend accounting
(hits stay $0-billed regardless of source).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np


def to_host(a: Any) -> np.ndarray:
    """A host numpy view of ``a``: torch tensors (on any device) are
    detached and copied to the CPU first, since ``np.asarray`` refuses a
    CUDA tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def content_key(row: Any) -> bytes:
    """Stable content hash of one request's (pytree) remote input."""
    h = hashlib.blake2b(digest_size=16)
    _update(h, row)
    return h.digest()


def content_keys(batch: Any, rows: int) -> list[bytes]:
    """Batched ``content_key`` over the leading axis of a stacked pytree.

    Produces byte-identical digests to ``content_key(row_i)`` where
    ``row_i`` is the i-th row of every leaf, but walks the tree ONCE:
    per-leaf header bytes (dtype + row shape) are computed a single time
    and each row is hashed from a contiguous slice — no per-row
    ``tree.map`` materialisation, no per-row re-layout. This is the hot
    path of the vectorised escalation gather (DESIGN.md §5).
    """
    hs = [hashlib.blake2b(digest_size=16) for _ in range(rows)]
    _update_batched(hs, batch)
    return [h.digest() for h in hs]


def _update_batched(hs: list, node: Any) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            enc = repr(k).encode()
            for h in hs:
                h.update(enc)
            _update_batched(hs, node[k])
    elif isinstance(node, (list, tuple)):
        for h in hs:
            h.update(b"[")
        for item in node:
            _update_batched(hs, item)
        for h in hs:
            h.update(b"]")
    else:
        a = np.ascontiguousarray(to_host(node))
        if a.shape[0] < len(hs):
            raise ValueError(f"leaf has {a.shape[0]} rows; need {len(hs)}")
        head = str(a.dtype).encode() + repr(a.shape[1:]).encode()
        for i, h in enumerate(hs):
            h.update(head)
            h.update(a[i].tobytes())


def _update(h, node: Any) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            h.update(repr(k).encode())
            _update(h, node[k])
    elif isinstance(node, (list, tuple)):
        h.update(b"[")
        for item in node:
            _update(h, item)
        h.update(b"]")
    else:
        a = to_host(node)
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def _row(node: Any, i: int) -> Any:
    """Slice row i out of a stacked pytree (custom-key_fn fallback)."""
    if isinstance(node, dict):
        return {k: _row(v, i) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_row(v, i) for v in node)
    return to_host(node)[i]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    # hits served from an entry that a *different* replica filled
    # (cluster shared cache, DESIGN.md §12); always 0 for a
    # single-process cache
    cross_hits: int = 0

    @property
    def hit_rate(self) -> float | None:
        """Hit ratio; None before any lookup — an untouched cache must
        not report a 0.0 hit rate (DESIGN.md §9 empty-stats contract)."""
        looked = self.hits + self.misses
        if looked == 0:
            return None
        return self.hits / looked


class RemoteResponseCache:
    """Bounded LRU of remote responses keyed by request content.

    ``key_fn`` maps one request's remote-input pytree to the hashable
    content that identifies it (default: the whole pytree). Override it
    when the pytree carries non-semantic fields — e.g. a per-request uid
    — that would make every key unique and the cache structurally cold.

    ``key_batch_fn(batch, rows) -> list[bytes]`` is the vectorised
    counterpart over a stacked sub-batch; supply it alongside a custom
    ``key_fn`` to keep the serving hot path free of per-row pytree
    slicing (the default pairing ``content_key``/``content_keys`` is
    wired automatically).
    """

    def __init__(self, capacity: int = 4096, key_fn=content_key,
                 key_batch_fn=None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self.key_fn = key_fn
        if key_batch_fn is None and key_fn is content_key:
            key_batch_fn = content_keys
        self.key_batch_fn = key_batch_fn
        self.stats = CacheStats()
        # key -> (response, source backend name | None)
        self._store: OrderedDict[bytes,
                                 tuple[np.ndarray, str | None]] = OrderedDict()

    def keys_for(self, batch: Any, rows: int) -> list[bytes]:
        """Keys for the leading ``rows`` of a stacked request pytree —
        batched when a ``key_batch_fn`` is available, else a per-row
        fallback through ``key_fn``."""
        if self.key_batch_fn is not None:
            return self.key_batch_fn(batch, rows)
        return [self.key_fn(_row(batch, i)) for i in range(rows)]

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, key: bytes) -> tuple[np.ndarray, str | None] | None:
        """Like ``get`` but returns ``(value, source)`` where ``source``
        is the backend name recorded at ``put`` time (None for entries
        stored without attribution)."""
        hit = self._store.get(key)
        if hit is None:
            self.stats.misses += 1
            return None
        self._store.move_to_end(key)
        self.stats.hits += 1
        return hit

    def get(self, key: bytes) -> np.ndarray | None:
        hit = self.lookup(key)
        return None if hit is None else hit[0]

    def put(self, key: bytes, value: np.ndarray,
            source: str | None = None) -> None:
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = (np.asarray(value), source)
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.stats.evictions += 1

    def clear(self) -> None:
        self._store.clear()
