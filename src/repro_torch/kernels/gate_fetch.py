"""The gate triple's trip to the host without a stall, and early emit.

The port's form of what ``jax.device_get`` and ``io_callback`` do for the
gate's ``(conf, pred, idx)`` triple in the JAX package (DESIGN.md §11).

``start_fetch(out)`` queues a copy of the triple into pinned host
buffers, fresh for every call, with ``non_blocking=True`` on the current
stream, and records a CUDA event right behind the copies. It returns at
once. The host reads the buffers only through ``PendingTriple.wait()``,
which waits on that event first. A pinned buffer read before its event
may still hold bytes from before the copy. Nothing on the CPU can show
that fault, so no other path reads them. A CPU triple comes back already
landed.

``emit_triple(emit, tag, out)`` is what a gate's ``emit`` does: it starts
the fetch, hands it to ``emit`` and returns it, so the caller waits on the
same copy.

``Emitter(emit)`` is the early-emit watcher: one daemon thread that waits
on each submitted ``PendingTriple`` in submission order with
``event.synchronize()`` (which releases the GIL, where a ``query()`` loop
would spin) and then calls ``emit(tag, conf, pred, idx)``. A triple that
has already landed, submitted while nothing is queued, is emitted on the
caller's thread, as the JAX package's callback fires inside the step on
the CPU. An exception raised by ``emit``, or a CUDA error met while
waiting, is kept and raised at the next ``submit``, ``wait`` or
``close``; the emitter takes no further triple after it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

import numpy as np
import torch

TRIPLE = ("conf", "pred", "idx")


class PendingTriple:
    """A gate triple on its way to the host: pinned buffers and the event
    recorded behind their copies (None for a triple that was on the CPU
    already)."""

    __slots__ = ("_host", "_event")

    def __init__(self, host: tuple[torch.Tensor, ...],
                 event: torch.cuda.Event | None):
        self._host = host
        self._event = event

    def ready(self) -> bool:
        """Whether the copies have landed (``event.query()``)."""
        return self._event is None or self._event.query()

    def wait(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block until the copies land, then the ``(conf, pred, idx)``
        numpy triple (views of this call's own buffers; read-only)."""
        if self._event is not None:
            self._event.synchronize()
        return tuple(t.numpy() for t in self._host)


def start_fetch(out: dict[str, torch.Tensor]) -> PendingTriple:
    """Queue the copy of ``out``'s ``conf``/``pred``/``idx`` to the host on
    the current stream of their device; returns without waiting."""
    src = tuple(out[k] for k in TRIPLE)
    dev = src[0].device
    if dev.type == "cpu":
        return PendingTriple(tuple(t.detach() for t in src), None)
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in src)
    for h, t in zip(host, src):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return PendingTriple(host, event)


def emit_triple(emit, emit_tag, out: dict[str, torch.Tensor]
                ) -> PendingTriple:
    """Hand the gate triple ``out`` to ``emit`` under the tag ``emit_tag``
    (0 for None) and return the triple's ``PendingTriple``: the one fetch
    that both ``emit`` and the caller wait on. ``emit`` is an ``Emitter``,
    or on a CPU triple also a plain callable, called at once."""
    tag = 0 if emit_tag is None else int(emit_tag)
    if isinstance(emit, Emitter):
        pending = start_fetch(out)
        emit.submit(tag, pending)
        return pending
    if out["conf"].device.type != "cpu":
        raise TypeError("on CUDA tensors emit must be a gate_fetch.Emitter "
                        "(its thread waits for the copy to land)")
    pending = start_fetch(out)
    emit(tag, *pending.wait())
    return pending


class Emitter:
    """Calls ``emit(tag, conf, pred, idx)`` for every submitted triple,
    in submission order, once it has landed (module docstring)."""

    def __init__(self, emit: Callable[..., None]):
        self._emit = emit
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._busy = False              # the thread holds a triple
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, tag: int, pending: PendingTriple) -> None:
        with self._cond:
            self._raise()
            if not self._queue and not self._busy and pending.ready():
                self._call(tag, pending)
                return
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="gate-emitter", daemon=True)
                self._thread.start()
            self._queue.append((tag, pending))
            self._cond.notify_all()

    def _call(self, tag: int, pending: PendingTriple) -> None:
        """Wait for one triple and emit it; keep what it raises."""
        if self._error is not None:
            return
        try:
            self._emit(tag, *pending.wait())
        except BaseException as e:      # raised at the next submit/wait/close
            self._error = e

    def _run(self) -> None:
        with self._cond:
            while True:
                while not self._queue:
                    self._cond.wait()
                item = self._queue.popleft()
                if item is None:
                    self._cond.notify_all()
                    return
                self._busy = True
                self._cond.release()    # wait and emit without the lock
                try:
                    self._call(*item)
                finally:
                    self._cond.acquire()
                    self._busy = False
                    self._cond.notify_all()

    def wait(self) -> None:
        """Block until every submitted triple has been emitted."""
        with self._cond:
            while self._queue or self._busy:
                self._cond.wait()
            self._raise()

    def close(self) -> None:
        """Emit what is queued, stop and join the thread (a later
        ``submit`` starts a new one)."""
        with self._cond:
            thread = self._thread
            if thread is not None:
                self._queue.append(None)
                self._cond.notify_all()
        if thread is not None:
            thread.join()
            self._thread = None
        with self._cond:
            self._raise()

    @property
    def alive(self) -> bool:
        """Whether the watcher thread is running."""
        return self._thread is not None and self._thread.is_alive()
