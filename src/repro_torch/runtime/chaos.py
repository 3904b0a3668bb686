"""Seeded, deterministic fault injection for the remote tier (DESIGN.md §10).

The paper's second supervisor exists because the remote tier cannot be
trusted blindly; the transport/router stack (DESIGN.md §3, §6) exists
because it cannot be *reached* reliably either. This module makes the
unreliable world reproducible: a ``ChaosSchedule`` scripts episodes of
misbehaviour — correlated multi-backend outages, partial brownouts,
error bursts, latency-inflation ramps, timeout storms, flapping links —
and wraps any ``RemoteTransport.remote_apply`` so the faults fire inside
the real retry/breaker/router machinery, not around it.

Determinism contract:

* **Count-indexed decisions.** Probabilistic faults (``brownout``) draw
  from a ``random.Random`` stream seeded per ``(schedule seed, episode,
  backend)`` and indexed by that wrapper's *call count*, never by time
  or thread interleaving. Windows are submitted in request order in
  every completion mode (DESIGN.md §7), so FIFO and streaming drains of
  the same request stream see the *same* faults — the billing-identity
  invariant survives chaos.
* **Virtual time.** Episodes activate on the transport's injectable
  clock; ``VirtualClock`` provides a thread-safe manual clock + sleep so
  a whole multi-episode schedule replays bit-identically with zero
  wall-clock waits (latency inflation advances the clock, the post-hoc
  deadline check in ``_call_window`` turns it into real timeouts).
* **Tagged faults.** Every injected exception message carries
  ``chaos[<episode>]`` and per-episode injection counts live in
  ``ChaosStats``, so event-log assertions can match cause to effect;
  ``chaos_episode_begin`` is emitted before the episode's first fault
  is raised, guaranteeing ``begin.seq < breaker_open.seq``.

Wrap a router in one line::

    schedule = ChaosSchedule([ChaosEpisode("outage", 8.0, 4.0,
                                           backends=("primary",))],
                             seed=7)
    schedule.wrap_router(router)
"""

from __future__ import annotations

import random
import threading
import zlib
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.runtime.cache import to_host
from repro_torch.runtime.observability import EV_CHAOS_BEGIN, EV_CHAOS_END
from repro_torch.runtime.transport import (RemoteBackend, RemoteCallError,
                                           RemoteRouter, RemoteTimeout,
                                           RemoteTransport)

__all__ = [
    "CHAOS_KINDS",
    "ChaosEpisode",
    "ChaosFault",
    "ChaosRemote",
    "ChaosSchedule",
    "ChaosStats",
    "ChaosTimeout",
    "VirtualClock",
]

# episode kinds (DESIGN.md §10):
#   outage        — every call fails (hard down)
#   brownout      — each call fails with probability ``rate`` (partial)
#   error_burst   — alias shape for a short rate-1.0 brownout; kept as
#                   its own kind so event logs name the failure mode
#   latency       — each call sleeps ``extra_latency_s`` first
#   latency_ramp  — like latency, scaled 0 -> extra_latency_s across the
#                   episode (a degradation, not a step)
#   timeout_storm — sleeps ``extra_latency_s`` then raises a timeout
#   flap          — down for the first half of every ``period_s``, up
#                   for the second (breaker-flapping link)
CHAOS_KINDS = ("outage", "brownout", "error_burst", "latency",
               "latency_ramp", "timeout_storm", "flap")
_FAULT_KINDS = ("outage", "brownout", "error_burst", "flap")


class ChaosFault(RemoteCallError):
    """Injected transient remote error (tagged with its episode)."""


class ChaosTimeout(RemoteTimeout):
    """Injected timeout (tagged with its episode)."""


class VirtualClock:
    """Thread-safe manual clock: ``clock()``/``sleep(dt)`` drop-ins for
    the transport's injectable hooks. ``sleep`` advances time instead of
    waiting, so latency inflation and breaker resets replay instantly;
    ``advance_to`` never moves backwards (drive loops race pool threads)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, dt: float) -> None:
        with self._lock:
            self._now += max(0.0, float(dt))

    def advance_to(self, t: float) -> None:
        with self._lock:
            self._now = max(self._now, float(t))


@dataclass(frozen=True)
class ChaosEpisode:
    """One scripted episode of remote-tier misbehaviour.

    ``backends=()`` hits every wrapped backend — that's how correlated
    multi-backend brownouts are scripted (one episode, many victims).
    ``rate`` applies to ``brownout``/``error_burst``; ``extra_latency_s``
    to ``latency``/``latency_ramp``/``timeout_storm``; ``period_s`` to
    ``flap``. ``name`` defaults to ``kind@start`` and is the tag carried
    by every fault message and episode event."""
    kind: str
    start_s: float
    duration_s: float
    backends: tuple[str, ...] = ()
    rate: float = 1.0
    extra_latency_s: float = 0.0
    period_s: float = 0.2
    name: str = ""

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"choose from {CHAOS_KINDS}")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        if self.period_s <= 0:
            raise ValueError("period_s must be > 0")
        if not self.name:
            object.__setattr__(self, "name",
                               f"{self.kind}@{self.start_s:g}")

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def covers(self, backend: str, now: float) -> bool:
        """Is this episode active for ``backend`` at time ``now``?"""
        if not self.start_s <= now < self.end_s:
            return False
        return not self.backends or backend in self.backends

    def progress(self, now: float) -> float:
        """Fraction of the episode elapsed at ``now`` (clipped [0, 1])."""
        return min(1.0, max(0.0, (now - self.start_s) / self.duration_s))


@dataclass
class ChaosStats:
    calls: int = 0              # wrapped remote_apply invocations seen
    injected: int = 0           # faults raised (timeouts + errors)
    delayed: int = 0            # calls slowed by latency episodes
    extra_latency_s: float = 0.0  # total injected latency
    by_episode: dict = field(default_factory=dict)  # name -> faults
    by_kind: dict = field(default_factory=dict)     # kind -> faults


class ChaosSchedule:
    """A seeded set of ``ChaosEpisode``s plus the shared injection state.

    ``wrap(backend)`` / ``wrap_router(router)`` splice a ``ChaosRemote``
    in front of each transport's ``remote_apply``; the wrapper reads the
    transport's injectable ``_clock``/``_sleep`` so virtual-clock runs
    replay without waits, and its (lazily installed) ``events`` log so
    episode begin/end markers land in the same sequence as the breaker
    events the faults cause."""

    def __init__(self, episodes, seed: int = 0):
        self.episodes = tuple(episodes)
        names = [ep.name for ep in self.episodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate episode names: {names}")
        self.seed = int(seed)
        self.stats = ChaosStats()
        self._lock = threading.Lock()
        self._begun: set[str] = set()
        self._ended: set[str] = set()

    def active(self, backend: str, now: float) -> list[ChaosEpisode]:
        return [ep for ep in self.episodes if ep.covers(backend, now)]

    def stream_seed(self, episode: ChaosEpisode, backend: str) -> int:
        """Seed for one (episode, backend) Bernoulli decision stream."""
        key = f"{self.seed}:{episode.name}:{backend}".encode()
        return zlib.crc32(key)

    # -- wiring ---------------------------------------------------------
    def wrap_transport(self, transport: RemoteTransport,
                       backend_name: str | None = None) -> ChaosRemote:
        """Splice a ``ChaosRemote`` in front of ``transport.remote_apply``
        (idempotent per transport: wrapping twice raises)."""
        if isinstance(transport.remote_apply, ChaosRemote):
            raise ValueError("transport is already chaos-wrapped")
        wrapper = ChaosRemote(transport.remote_apply,
                              backend_name or transport.event_source,
                              self, transport=transport)
        transport.remote_apply = wrapper
        return wrapper

    def wrap(self, backend: RemoteBackend) -> RemoteBackend:
        self.wrap_transport(backend.transport, backend.name)
        return backend

    def wrap_router(self, router: RemoteRouter) -> RemoteRouter:
        for b in router.backends:
            self.wrap(b)
        return router

    # -- episode begin/end markers --------------------------------------
    def mark(self, now: float, events: Any) -> None:
        """Emit begin/end events for episodes whose activation state is
        newly visible at ``now``. Called by wrappers *before* they raise
        the episode's fault, so cause precedes effect in seq order."""
        with self._lock:
            pending: list[tuple[str, ChaosEpisode]] = []
            for ep in self.episodes:
                if ep.start_s <= now and ep.name not in self._begun:
                    self._begun.add(ep.name)
                    pending.append((EV_CHAOS_BEGIN, ep))
                if now >= ep.end_s and ep.name not in self._ended:
                    self._ended.add(ep.name)
                    pending.append((EV_CHAOS_END, ep))
        if events is not None:
            for kind, ep in pending:
                events.emit(kind, episode=ep.name, chaos_kind=ep.kind,
                            start_s=ep.start_s, end_s=ep.end_s,
                            targets=list(ep.backends) or None)

    def finalize(self, events: Any, now: float | None = None) -> None:
        """Emit end markers for episodes still open when traffic stopped
        (an episode ends silently if no call observes the time after it;
        benches call this once after the drive loop)."""
        self.mark(float("inf") if now is None else now, events)


class ChaosRemote:
    """Callable wrapper around one transport's ``remote_apply``.

    Applies the schedule's active episodes on every call: latency first
    (``_sleep`` — virtual or real), then at most one fault. Decision
    order is schedule order; per-episode call counts and rng streams
    live here (per backend), so two wrappers never share state and a
    replay with the same per-backend call order is bit-identical."""

    def __init__(self, inner: Callable, backend: str,
                 schedule: ChaosSchedule, *,
                 transport: RemoteTransport | None = None,
                 clock: Callable[[], float] | None = None,
                 sleep: Callable[[float], None] | None = None):
        self.inner = inner
        self.backend = backend
        self.schedule = schedule
        self._transport = transport
        self._clock = clock if clock is not None else transport._clock
        self._sleep = sleep if sleep is not None else transport._sleep
        self._calls: dict[str, int] = {}          # episode -> calls seen
        self._streams: dict[str, random.Random] = {}

    def _events(self) -> Any:
        # resolved lazily: Observability.install() wires transport.events
        # after construction, possibly after wrapping
        return self._transport.events if self._transport is not None else None

    def _decide(self, ep: ChaosEpisode, now: float) -> bool:
        """Should this call fail under ``ep``? (count-indexed for the
        probabilistic kinds, time-based for deterministic ones)"""
        if ep.kind == "outage":
            return True
        if ep.kind == "flap":
            # down for the first half of each period — deterministic in
            # (virtual) time, so replays flap identically
            return (now - ep.start_s) % ep.period_s < ep.period_s / 2
        # brownout / error_burst: one Bernoulli draw per call, from the
        # per-(episode, backend) stream — the call index IS the stream
        # position, immune to completion-order differences
        rng = self._streams.get(ep.name)
        if rng is None:
            rng = self._streams[ep.name] = random.Random(
                self.schedule.stream_seed(ep, self.backend))
        return rng.random() < ep.rate

    def __call__(self, batch: Any) -> Any:
        sched = self.schedule
        now = self._clock()
        extra = 0.0
        fault: tuple[ChaosEpisode, str] | None = None
        with sched._lock:
            sched.stats.calls += 1
            active = sched.active(self.backend, now)
            for ep in active:
                self._calls[ep.name] = self._calls.get(ep.name, 0) + 1
            for ep in active:
                if ep.kind in ("latency", "latency_ramp", "timeout_storm"):
                    scale = (ep.progress(now) if ep.kind == "latency_ramp"
                             else 1.0)
                    extra += ep.extra_latency_s * scale
                if fault is None and ep.kind == "timeout_storm":
                    fault = (ep, "timeout")
                if (fault is None and ep.kind in _FAULT_KINDS
                        and self._decide(ep, now)):
                    fault = (ep, "error")
            if fault is not None:
                ep = fault[0]
                sched.stats.injected += 1
                sched.stats.by_episode[ep.name] = (
                    sched.stats.by_episode.get(ep.name, 0) + 1)
                sched.stats.by_kind[ep.kind] = (
                    sched.stats.by_kind.get(ep.kind, 0) + 1)
            if extra > 0.0:
                sched.stats.delayed += 1
                sched.stats.extra_latency_s += extra
        # cause-before-effect: episode markers enter the log before the
        # fault below can trip a breaker
        sched.mark(now, self._events())
        if extra > 0.0:
            self._sleep(extra)
        if fault is not None:
            ep, mode = fault
            if mode == "timeout":
                raise ChaosTimeout(f"chaos[{ep.name}] injected timeout "
                                   f"({ep.kind})")
            raise ChaosFault(f"chaos[{ep.name}] injected fault ({ep.kind})")
        # the inner apply may answer with a device tensor
        return to_host(self.inner(batch))
