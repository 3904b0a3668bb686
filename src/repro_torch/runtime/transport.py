"""Fault-aware remote-tier transport (runtime control plane, DESIGN.md §3).

The paper treats the remote DNN as an infallible local callable; real
deployments (DDNN-style cloud/edge tiers, CheapET-3's billed web API) see
timeouts, transient errors and outages. This module wraps the remote
callable in:

  * bounded in-flight windows — the escalated sub-batch is shipped in
    chunks of at most ``max_in_flight`` requests, so a single failure only
    degrades its window, never the whole batch;
  * per-window deadline + bounded retries with backoff;
  * a circuit breaker: after ``breaker_failures`` consecutive window
    failures the breaker opens and remote calls short-circuit locally for
    ``breaker_reset_s``; a single half-open probe then decides whether to
    close it again.

A failed window does NOT drop its requests: the engine maps them to the
REJECTED/fallback path of Algorithm 1 (the 2nd-level supervisor's "raise
Exception" branch), which the scheduler resolves via the fallback callable.

For the pipelined serving path (DESIGN.md §5) the transport also exposes a
non-blocking futures API: ``submit(batch)`` schedules the same windowed /
retried / breaker-guarded ``call`` on a thread pool and returns a
``TransportFuture``; ``poll``/``result`` drain it. Breaker and stats
mutations are lock-protected so concurrent in-flight windows stay
consistent; the remote callable itself runs unlocked and must be
thread-safe when ``max_concurrent > 1``.

The clock and sleep functions are injectable so tests and benchmarks can
run outage episodes deterministically without wall-clock waits.

Multi-remote routing (DESIGN.md §6): real deployments see a *market* of
remote models at different per-call prices and latencies (CheapET-3), and
tiered escalation across multiple upstream endpoints (DDNN). A
``RemoteBackend`` is one named remote tier — its own transport (config,
breaker, pool, stats) plus routing metadata (``cost_per_request``,
modelled ``latency_s``) — and a ``RemoteRouter`` owns N backends and picks
one per escalation window under a pluggable policy:

  * ``primary-failover``    — registration order; later backends are hot
    standbys;
  * ``cheapest-available``  — ascending ``cost_per_request``;
  * ``latency-ema``         — ascending measured latency EMA (seeded from
    the modelled ``latency_s`` until a backend has observations);
  * ``weighted``            — spread windows across equally-priced healthy
    backends by inverse in-flight count (load balancing — DESIGN.md §8).

Per-request policy (DESIGN.md §8): ``pick``/``redeem_replay`` accept a
``RouteConstraint`` merged from the window's escalated rows — a cost
ceiling, a remaining-deadline latency ceiling and an advisory backend
hint — and ``min_available_cost``/``min_latency_estimate`` expose the
feasibility signals the engine's deadline/cost downgrades consult.

``pick()`` skips any backend whose breaker would refuse the call *at
submit time* (the speculative-failover fast path: an open breaker reroutes
the window immediately instead of waiting for the drain to observe the
failure). When NO backend is available the window may park with a bounded
replay ticket (``acquire_replay_slot``/``redeem_replay``): at drain time
it gets one more pick, so a breaker that half-opens while the window rides
the pipeline serves it — the replay doubles as the half-open probe —
instead of the escalation degrading to REJECTED (DESIGN.md §7).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar

import numpy as np

from .cache import to_host
from .observability import (
    EV_BREAKER_CLOSE,
    EV_BREAKER_HALF_OPEN,
    EV_BREAKER_OPEN,
    EV_REPLAY_DROPPED,
    EV_REPLAY_PARKED,
    EV_REPLAY_SERVED,
    EV_ROUTER_FAILBACK,
    EV_ROUTER_FAILOVER,
    span,
)


class RemoteCallError(Exception):
    """Remote tier invocation failed (transient or terminal)."""


class RemoteTimeout(RemoteCallError):
    """Remote tier exceeded its deadline (raise from fault hooks too)."""


class CircuitOpenError(RemoteCallError):
    """Call short-circuited: the breaker is open."""


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass(frozen=True)
class TransportConfig:
    max_in_flight: int = 8        # requests per transport window
    timeout_s: float = 2.0        # per-window deadline
    max_retries: int = 2          # retries per window (beyond first try)
    retry_backoff_s: float = 0.02   # base of the exponential backoff
    retry_backoff_cap_s: float = 1.0  # backoff ceiling (pre-jitter)
    retry_jitter_seed: int = 0    # per-transport seed for backoff jitter
    breaker_failures: int = 3     # consecutive window failures to open
    breaker_reset_s: float = 5.0  # open -> half-open after this long
    max_concurrent: int = 8       # submit() thread-pool width


@dataclass
class TransportStats:
    windows: int = 0
    requests: int = 0
    failed_requests: int = 0
    retries: int = 0
    timeouts: int = 0
    errors: int = 0
    short_circuited: int = 0      # requests rejected while breaker open
    breaker_opens: int = 0
    # measured per-window remote latency (successful windows only): the
    # EMA feeds the router's latency-ema policy, the ring buffer feeds
    # the per-backend p95 reported by the serving/routing benchmarks
    latency_sum_s: float = 0.0
    latency_windows: int = 0
    latency_ema_s: float | None = None
    latency_samples: deque = field(
        default_factory=lambda: deque(maxlen=4096), repr=False)

    LATENCY_EMA_ALPHA: ClassVar[float] = 0.2

    def record_latency(self, window_s: float) -> None:
        self.latency_sum_s += window_s
        self.latency_windows += 1
        self.latency_ema_s = (window_s if self.latency_ema_s is None else
                              self.LATENCY_EMA_ALPHA * window_s
                              + (1 - self.LATENCY_EMA_ALPHA)
                              * self.latency_ema_s)
        self.latency_samples.append(float(window_s))

    @property
    def mean_latency_s(self) -> float | None:
        """Mean per-window remote latency; None before any successful
        window — a transport that never measured anything must not
        report a flattering 0.0 (DESIGN.md §9 empty-stats contract)."""
        if self.latency_windows == 0:
            return None
        return self.latency_sum_s / self.latency_windows

    def latency_percentile(self, q: float) -> float | None:
        """q-th percentile (0-100) of recent per-window remote latency;
        None when no window has succeeded yet."""
        if not self.latency_samples:
            return None
        return float(np.percentile(np.fromiter(self.latency_samples,
                                               np.float64), q))


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(self, failures: int, reset_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failures)
        self.reset_s = reset_s
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opens = 0
        self._opened_at = 0.0

    def allow(self) -> bool:
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.reset_s:
                self.state = HALF_OPEN     # admit one probe
                return True
            return False
        return True

    def would_allow(self) -> bool:
        """Non-mutating peek: should the router hand this breaker a new
        window right now? OPEN admits once the reset has elapsed (that
        pick becomes the probe); HALF_OPEN refuses — a probe is already
        in flight, and routing more windows at a still-unproven backend
        would burn them if the probe fails (``allow()`` itself stays
        permissive in HALF_OPEN so the in-flight probe's retries pass)."""
        if self.state == OPEN:
            return self._clock() - self._opened_at >= self.reset_s
        if self.state == HALF_OPEN:
            return False
        return True

    def try_probe(self) -> bool:
        """OPEN -> HALF_OPEN when the reset window has elapsed; the caller
        becomes the single in-flight probe. The router calls this at pick
        time so the half-open transition is *sequenced before* the events
        the probe causes (router_failback, breaker_close) — DESIGN.md §9's
        causal ordering would otherwise break because ``would_allow()``
        only peeks. Returns True iff the transition happened here."""
        if (self.state == OPEN
                and self._clock() - self._opened_at >= self.reset_s):
            self.state = HALF_OPEN
            return True
        return False

    def record_success(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if (self.state == HALF_OPEN
                or self.consecutive_failures >= self.failure_threshold):
            if self.state != OPEN:
                self.opens += 1
            self.state = OPEN
            self._opened_at = self._clock()


def _rows(batch: Any) -> int:
    if isinstance(batch, dict):
        return _rows(next(iter(batch.values())))
    return int(np.asarray(batch).shape[0])


def _slice(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: _slice(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


class TransportFuture:
    """Handle for one in-flight ``submit``; resolves to ``(logits, ok)``.

    ``result`` never raises for remote faults — failures surface as
    ``ok == False`` rows, exactly like the synchronous ``call``.
    """

    def __init__(self, future: Future, n: int):
        self._future = future
        self.n = n                # requests riding on this future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def add_done_callback(self, fn: Callable[["TransportFuture"], Any]
                          ) -> None:
        """Invoke ``fn(self)`` (from the pool thread) once the future
        resolves. The streaming drain (DESIGN.md §7) registers a wakeup
        here so it can park on an event covering EVERY in-flight window
        across every backend, instead of polling the head-of-line future
        — any window resolving, on any backend's pool, wakes the drain.
        Exceptions in ``fn`` are swallowed by the executor; keep it to a
        flag/event set."""
        self._future.add_done_callback(lambda _f: fn(self))


class RemoteTransport:
    """Windowed, retried, breaker-guarded wrapper over a remote callable.

    ``call(batch)`` returns ``(logits [n, C] float32, ok [n] bool)``:
    per-request success flags instead of an exception, so partial failures
    degrade to per-request fallback rather than batch loss. Rows with
    ``ok == False`` have zero logits and must not be trusted.

    ``submit(batch)`` is the non-blocking variant: the same call runs on
    a thread pool and the returned ``TransportFuture`` resolves to the
    identical ``(logits, ok)`` pair — the pipelined engine keeps several
    microbatches in flight this way (DESIGN.md §5).
    """

    def __init__(self, remote_apply: Callable, config: TransportConfig
                 = TransportConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.remote_apply = remote_apply
        self.config = config
        self.stats = TransportStats()
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._pool: ThreadPoolExecutor | None = None
        # attempts run on their own pool so the bounded result() wait can
        # abandon a hung remote_apply without wedging the caller — which
        # may itself be a submit()-pool thread (same pool would deadlock).
        # Created (and one worker pre-spawned) eagerly: the first window
        # attempt must not pay pool/thread start-up inside its deadline.
        self._attempt_pool: ThreadPoolExecutor | None = None
        self._attempts()
        # deterministic backoff jitter: seeded per transport, drawn under
        # the lock so a fixed seed gives a reproducible delay sequence
        self._backoff_rng = random.Random(config.retry_jitter_seed)
        self.breaker = CircuitBreaker(config.breaker_failures,
                                      config.breaker_reset_s, clock=clock)
        # observability (DESIGN.md §9): an EventLog installed by the
        # Observability facade; None = disabled, every hook short-circuits
        # on one attribute test. ``event_source`` is the backend name the
        # router wires in (a bare transport reports as "remote").
        self.events: Any = None
        self.event_source = "remote"

    _BREAKER_EVENTS: ClassVar[dict] = {OPEN: EV_BREAKER_OPEN,
                                       HALF_OPEN: EV_BREAKER_HALF_OPEN,
                                       CLOSED: EV_BREAKER_CLOSE}

    def _emit_breaker(self, prev: str, cur: str, tag: int | None) -> None:
        """Emit a breaker state-transition event (call OUTSIDE the
        transport lock; prev/cur were captured inside it)."""
        if self.events is None or cur == prev:
            return
        self.events.emit(self._BREAKER_EVENTS[cur], window=tag,
                         backend=self.event_source, prev=prev,
                         failures=self.breaker.consecutive_failures)

    # -- single window -----------------------------------------------------
    def _attempts(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._attempt_pool is None:
                # +2 slack: a timed-out attempt abandons its thread until
                # the hung remote_apply returns; a couple of stragglers
                # must not starve fresh attempts (if more pile up, queued
                # attempts time out in result() and the breaker opens)
                self._attempt_pool = ThreadPoolExecutor(
                    max_workers=max(1, self.config.max_concurrent) + 2,
                    thread_name_prefix="remote-attempt")
                # pre-spawn one worker: the first real attempt must not
                # pay thread-start latency inside the window deadline
                self._attempt_pool.submit(lambda: None)
            return self._attempt_pool

    def _call_window(self, window: Any) -> np.ndarray:
        """One attempt, with the deadline enforced both ways: the attempt
        runs on a dedicated pool and the wait is bounded in *wall* time
        (a hung remote_apply is abandoned, not awaited forever), and the
        elapsed time on the injectable clock is checked after the fact so
        chaos schedules driving a virtual clock still produce timeouts
        without real waits."""
        t0 = self._clock()
        fut = self._attempts().submit(self._attempt, window)
        try:
            out = to_host(fut.result(timeout=self.config.timeout_s))
        except FutureTimeout:
            fut.cancel()        # not started -> never runs; else abandoned
            raise RemoteTimeout(
                f"remote window exceeded {self.config.timeout_s}s "
                f"deadline (attempt abandoned)") from None
        if self._clock() - t0 > self.config.timeout_s:
            raise RemoteTimeout(
                f"remote window exceeded {self.config.timeout_s}s deadline")
        return out

    def _attempt(self, window: Any) -> Any:
        """``remote_apply`` on an attempt thread, timed on the card too
        while a profiler records."""
        with span("transport.attempt", device=True):
            return self.remote_apply(window)

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with seeded jitter: base * 2^attempt
        clipped at the cap, then scaled into [0.5, 1.0) so windows that
        failed together don't retry in lockstep against a recovering
        backend (linear backoff synchronized them). The rng is seeded per
        transport (``retry_jitter_seed``), so tests replaying a schedule
        see the same delay sequence."""
        raw = min(self.config.retry_backoff_s * (2 ** attempt),
                  self.config.retry_backoff_cap_s)
        with self._lock:
            return raw * (0.5 + 0.5 * self._backoff_rng.random())

    def _call_with_retries(self, window: Any,
                           tag: int | None = None) -> np.ndarray:
        """One window: retries absorb transient faults; only a window that
        exhausts its retries counts as a breaker failure (so a single
        flaky window never opens the breaker on its own)."""
        last: Exception | None = None
        t0 = self._clock()      # latency = time-to-success incl. retries,
        for attempt in range(1 + self.config.max_retries):  # so a flaky
            # backend can't report a flattering EMA/p95 to the router
            with self._lock:
                prev = self.breaker.state
                allowed = self.breaker.allow()
                cur = self.breaker.state
            self._emit_breaker(prev, cur, tag)
            if not allowed:
                raise CircuitOpenError("circuit breaker open")
            try:
                out = self._call_window(window)
            except RemoteTimeout as e:
                with self._lock:
                    self.stats.timeouts += 1
                last = e
            except CircuitOpenError:
                raise
            except Exception as e:  # transient transport / remote error
                with self._lock:
                    self.stats.errors += 1
                last = e
            else:
                with self._lock:
                    self.stats.record_latency(self._clock() - t0)
                    prev = self.breaker.state
                    self.breaker.record_success()
                    cur = self.breaker.state
                self._emit_breaker(prev, cur, tag)
                return out
            if attempt < self.config.max_retries:
                with self._lock:
                    self.stats.retries += 1
                if self.config.retry_backoff_s > 0:
                    self._sleep(self._backoff(attempt))
        with self._lock:
            prev = self.breaker.state
            self.breaker.record_failure()
            cur = self.breaker.state
        self._emit_breaker(prev, cur, tag)
        raise RemoteCallError(f"remote window failed after "
                              f"{1 + self.config.max_retries} attempts: "
                              f"{last!r}") from last

    # -- public API --------------------------------------------------------
    def call(self, batch: Any, tag: int | None = None
             ) -> tuple[np.ndarray | None, np.ndarray]:
        n = _rows(batch)
        ok = np.zeros((n,), bool)
        outs: list[tuple[int, np.ndarray]] = []
        w = max(1, self.config.max_in_flight)
        for lo in range(0, n, w):
            hi = min(lo + w, n)
            with self._lock:
                self.stats.windows += 1
                self.stats.requests += hi - lo
                prev = self.breaker.state
                allowed = self.breaker.allow()
                cur = self.breaker.state
            self._emit_breaker(prev, cur, tag)
            if not allowed:
                with self._lock:
                    self.stats.short_circuited += hi - lo
                    self.stats.failed_requests += hi - lo
                continue
            try:
                with span("transport.window"):
                    out = self._call_with_retries(_slice(batch, lo, hi),
                                                  tag)
            except CircuitOpenError:
                with self._lock:
                    self.stats.short_circuited += hi - lo
                    self.stats.failed_requests += hi - lo
                continue
            except RemoteCallError:
                with self._lock:
                    self.stats.failed_requests += hi - lo
                continue
            ok[lo:hi] = True
            outs.append((lo, out))
        with self._lock:
            self.stats.breaker_opens = self.breaker.opens
        if not outs:
            return None, ok
        width = outs[0][1].shape[1:]
        logits = np.zeros((n,) + width, np.float32)
        for lo, out in outs:
            logits[lo:lo + out.shape[0]] = out
        return logits, ok

    def submit(self, batch: Any, tag: int | None = None) -> TransportFuture:
        """Non-blocking ``call``: schedule the batch on the thread pool and
        return a future resolving to the same ``(logits, ok)`` pair."""
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(1, self.config.max_concurrent),
                    thread_name_prefix="remote-transport")
            pool = self._pool
        return TransportFuture(pool.submit(self.call, batch, tag),
                               _rows(batch))

    def poll(self, future: TransportFuture) -> bool:
        """True iff the future's (logits, ok) is ready to drain."""
        return future.done()

    def grant_probe(self, tag: int | None = None) -> None:
        """Transition an elapsed OPEN breaker to HALF_OPEN *now* and emit
        the transition. The router calls this for the backend it picked,
        so ``breaker_half_open`` is sequenced before any failback/close
        event the probe window goes on to cause (DESIGN.md §9)."""
        with self._lock:
            prev = self.breaker.state
            granted = self.breaker.try_probe()
        if granted:
            self._emit_breaker(prev, self.breaker.state, tag)

    def shutdown(self, wait: bool = True) -> None:
        """Tear down the submit() pool (in-flight calls finish if wait)."""
        with self._lock:
            pool, self._pool = self._pool, None
            attempts, self._attempt_pool = self._attempt_pool, None
        if pool is not None:
            pool.shutdown(wait=wait)
        if attempts is not None:
            # never wait on the attempt pool: an abandoned hung attempt
            # would block shutdown forever (the bug this pool fixes)
            attempts.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Multi-remote tier registry + routing (DESIGN.md §6)
# ---------------------------------------------------------------------------

class RemoteBackend:
    """One named remote tier in the registry.

    Owns a full ``RemoteTransport`` (per-backend config, breaker, thread
    pool, stats) plus the routing/billing metadata the engine and router
    need: ``cost_per_request`` (per-call price; None = use the engine's
    ``CostModel`` default) and ``latency_s`` (modelled round trip; None =
    CostModel default). Construct either around a callable::

        RemoteBackend("gpt-large", remote_apply, TransportConfig(...),
                      cost_per_request=0.0048, latency_s=0.32)

    or around an existing transport (``transport=...``) — the adapter the
    engine uses to keep a bare single-transport construction working.
    """

    def __init__(self, name: str, remote_apply: Callable | None = None,
                 config: TransportConfig = TransportConfig(), *,
                 cost_per_request: float | None = None,
                 latency_s: float | None = None,
                 transport: RemoteTransport | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if transport is None:
            if remote_apply is None:
                raise ValueError("RemoteBackend needs remote_apply or "
                                 "transport")
            transport = RemoteTransport(remote_apply, config,
                                        clock=clock, sleep=sleep)
        self.name = name
        self.transport = transport
        self.cost_per_request = cost_per_request
        self.latency_s = latency_s
        # windows handed to this backend and not yet resolved — the
        # `weighted` routing policy's load signal
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- delegation to the owned transport -----------------------------
    @property
    def config(self) -> TransportConfig:
        return self.transport.config

    @property
    def breaker(self) -> CircuitBreaker:
        return self.transport.breaker

    @property
    def stats(self) -> TransportStats:
        return self.transport.stats

    def call(self, batch: Any, tag: int | None = None):
        self._track(+1)
        try:
            return self.transport.call(batch, tag)
        finally:
            self._track(-1)

    def submit(self, batch: Any, tag: int | None = None) -> TransportFuture:
        self._track(+1)
        try:
            fut = self.transport.submit(batch, tag)
        except BaseException:
            self._track(-1)     # pool-shutdown race etc.: don't leak the
            raise               # counter and skew `weighted` routing
        fut.add_done_callback(lambda _f: self._track(-1))
        return fut

    def poll(self, future: TransportFuture) -> bool:
        return self.transport.poll(future)

    def shutdown(self, wait: bool = True) -> None:
        self.transport.shutdown(wait=wait)

    def _track(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight = max(0, self._inflight + delta)

    @property
    def inflight(self) -> int:
        """Windows routed here and not yet resolved (load signal)."""
        with self._inflight_lock:
            return self._inflight

    # -- routing signals ------------------------------------------------
    def available(self) -> bool:
        """Would this backend's breaker admit a call right now?"""
        return self.breaker.would_allow()

    def latency_estimate(self) -> float:
        """Measured latency EMA; falls back to the modelled ``latency_s``
        prior (0.0 if neither — an untried backend is worth probing)."""
        if self.stats.latency_ema_s is not None:
            return self.stats.latency_ema_s
        return self.latency_s if self.latency_s is not None else 0.0

    def __repr__(self) -> str:
        return (f"RemoteBackend({self.name!r}, "
                f"cost={self.cost_per_request}, "
                f"latency={self.latency_s})")


ROUTE_POLICIES = ("primary-failover", "cheapest-available", "latency-ema",
                  "weighted")


@dataclass(frozen=True)
class RouteConstraint:
    """Per-window routing constraint merged from the escalated rows'
    ``RequestPolicy`` objects (DESIGN.md §8). One window is served by one
    backend, so the backend must satisfy the *tightest* row: ``max_cost``
    is the smallest ``cost_cap`` present, ``max_latency_s`` the smallest
    remaining deadline. ``hint`` is advisory — the hinted backend is
    preferred when available and satisfying; ``default_cost`` prices
    backends that carry no ``cost_per_request`` of their own (the
    engine's CostModel constant)."""
    max_cost: float | None = None
    max_latency_s: float | None = None
    hint: str | None = None
    default_cost: float | None = None

    def admits(self, backend: "RemoteBackend") -> bool:
        if self.max_cost is not None:
            cost = (backend.cost_per_request
                    if backend.cost_per_request is not None
                    else self.default_cost)
            if cost is not None and cost > self.max_cost + 1e-12:
                return False
        if (self.max_latency_s is not None
                and backend.latency_estimate() > self.max_latency_s):
            return False
        return True


@dataclass
class RouterStats:
    picks: dict = field(default_factory=dict)   # backend name -> windows
    failovers: int = 0          # picks that skipped the preferred backend
    unrouted: int = 0           # windows with NO available backend
    # bounded replay of (unrouted) windows (DESIGN.md §7): instead of
    # degrading straight to REJECTED, up to ``replay_max`` windows park
    # until their drain and get one more pick — served iff some breaker
    # has half-opened in the meantime
    replay_enqueued: int = 0    # windows parked with a replay ticket
    replay_served: int = 0      # redeemed by a recovered backend
    replay_dropped: int = 0     # queue full at park, or still no backend


class RemoteRouter:
    """Registry of ``RemoteBackend``s + a routing policy.

    ``pick()`` returns the first *available* backend in policy order —
    a backend whose breaker is open (and not yet due a half-open probe)
    is skipped at submit time, so an outage fails over within the same
    escalation window (speculative failover). Returns None only when no
    backend is available; the engine then maps the window straight to the
    REJECTED/fallback path without touching any transport.

    Candidate order per policy:
      * primary-failover   — registration order;
      * cheapest-available — ascending ``cost_per_request`` (unknown cost
        sorts last; registration order breaks ties);
      * latency-ema        — ascending ``latency_estimate()`` (measured
        EMA, modelled prior until observations arrive).
    """

    def __init__(self, backends: list[RemoteBackend],
                 policy: str = "primary-failover", *,
                 replay_max: int = 8):
        backends = list(backends)
        if not backends:
            raise ValueError("router needs at least one backend")
        names = [b.name for b in backends]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate backend names: {names}")
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {ROUTE_POLICIES}")
        self.backends = backends
        self.policy = policy
        self.replay_max = max(0, replay_max)
        self._replay_slots = 0      # tickets currently parked with windows
        self.stats = RouterStats(picks={b.name: 0 for b in backends})
        # observability (DESIGN.md §9): shared EventLog, installed by the
        # Observability facade (None = disabled). ``_failed_over`` tracks
        # whether routing has drifted off the policy-preferred backend so
        # the return to it is emitted as one fail-back event.
        self.events: Any = None
        self._failed_over = False

    def __len__(self) -> int:
        return len(self.backends)

    def __iter__(self):
        return iter(self.backends)

    def attach_events(self, events: Any) -> None:
        """Wire this router and every backend transport into one event
        log. Idempotent; the Observability facade calls it at install
        time, and the cluster harness re-points a shared router at the
        raw fleet-level log after per-replica installs (DESIGN.md §12)."""
        self.events = events
        for b in self.backends:
            b.transport.events = events
            b.transport.event_source = b.name

    def backend(self, name: str) -> RemoteBackend:
        for b in self.backends:
            if b.name == name:
                return b
        raise KeyError(name)

    def candidates(self) -> list[RemoteBackend]:
        """All backends in policy preference order (availability is NOT
        applied here — ``pick`` filters on breaker state)."""
        if self.policy == "cheapest-available":
            return sorted(self.backends,
                          key=lambda b: (b.cost_per_request is None,
                                         b.cost_per_request or 0.0))
        if self.policy == "latency-ema":
            return sorted(self.backends, key=RemoteBackend.latency_estimate)
        if self.policy == "weighted":
            # spread windows across equally-priced backends by inverse
            # in-flight count (least-loaded first; price still dominates,
            # registration order breaks the remaining ties)
            return sorted(self.backends,
                          key=lambda b: (b.cost_per_request is None,
                                         b.cost_per_request or 0.0,
                                         b.inflight))
        return list(self.backends)

    def _ordered(self, constraint: RouteConstraint | None
                 ) -> list[RemoteBackend]:
        """Policy order with an advisory routing hint applied: the hinted
        backend (if registered) moves to the front of the candidate
        list; constraint filtering still applies to it."""
        cands = self.candidates()
        if constraint is not None and constraint.hint is not None:
            hinted = [b for b in cands if b.name == constraint.hint]
            if hinted:
                cands = hinted + [b for b in cands if b is not hinted[0]]
        return cands

    def pick(self, constraint: RouteConstraint | None = None, *,
             window: int | None = None) -> RemoteBackend | None:
        """First available backend in policy order that satisfies the
        window's merged ``RouteConstraint`` (None = unconstrained); None
        when every breaker (or the constraint) refuses — the window
        degrades to REJECTED/fallback. ``failovers`` counts picks that
        skipped a breaker-refused preferred backend (constraint skips are
        policy, not failure)."""
        skipped_unavailable = False
        ordered = self._ordered(constraint)
        for b in ordered:
            if not b.available():
                skipped_unavailable = True
                continue
            if constraint is not None and not constraint.admits(b):
                continue
            # an elapsed OPEN breaker half-opens HERE, not when the call
            # hits the wire: the half_open event must be sequenced before
            # the failback/close events this probe window causes
            b.transport.grant_probe(window)
            self.stats.picks[b.name] += 1
            if skipped_unavailable:
                self.stats.failovers += 1
                self._failed_over = True
                if self.events is not None:
                    self.events.emit(EV_ROUTER_FAILOVER, window=window,
                                     backend=b.name, policy=self.policy)
            elif self._failed_over and b is ordered[0]:
                self._failed_over = False
                if self.events is not None:
                    self.events.emit(EV_ROUTER_FAILBACK, window=window,
                                     backend=b.name, policy=self.policy)
            return b
        self.stats.unrouted += 1
        return None

    # -- policy-layer feasibility signals (DESIGN.md §8) ----------------
    def min_available_cost(self, default: float) -> float | None:
        """Cheapest per-call price among currently-available backends
        (``default`` prices backends without their own); None when no
        backend is available. The engine's cost-cap feasibility check."""
        costs = [b.cost_per_request if b.cost_per_request is not None
                 else default for b in self.backends if b.available()]
        return min(costs) if costs else None

    def min_latency_estimate(self, *, max_cost: float | None = None,
                             default_cost: float | None = None
                             ) -> float | None:
        """Fastest round-trip estimate among available backends (optional
        cost ceiling applied first); None when no backend qualifies. The
        engine's deadline-vs-EMA feasibility check (DESIGN.md §8)."""
        ests = []
        for b in self.backends:
            if not b.available():
                continue
            if max_cost is not None:
                cost = (b.cost_per_request
                        if b.cost_per_request is not None else default_cost)
                if cost is not None and cost > max_cost + 1e-12:
                    continue
            ests.append(b.latency_estimate())
        return min(ests) if ests else None

    # -- bounded replay of (unrouted) windows (DESIGN.md §7) ------------
    def acquire_replay_slot(self, *, window: int | None = None) -> bool:
        """Park an (unrouted) escalation window for a later replay pick
        instead of degrading it to REJECTED immediately. Bounded: at most
        ``replay_max`` windows may hold a ticket at once — a full queue
        returns False and the window falls back as before. The engine
        redeems the ticket when the window drains (``redeem_replay``)."""
        if self._replay_slots >= self.replay_max:
            self.stats.replay_dropped += 1
            if self.events is not None:
                self.events.emit(EV_REPLAY_DROPPED, window=window,
                                 reason="queue_full")
            return False
        self._replay_slots += 1
        self.stats.replay_enqueued += 1
        if self.events is not None:
            self.events.emit(EV_REPLAY_PARKED, window=window,
                             parked=self._replay_slots)
        return True

    def redeem_replay(self, constraint: RouteConstraint | None = None, *,
                      window: int | None = None) -> RemoteBackend | None:
        """Replay pick for a parked (unrouted) window at drain time: the
        first backend in policy order whose breaker has half-opened since
        submit serves the window — the replay call doubles as the probe —
        and billing attributes to that backend. Returns None when every
        breaker still refuses (the window keeps the REJECTED/fallback
        path). Always releases the ticket's slot."""
        self._replay_slots = max(0, self._replay_slots - 1)
        for b in self._ordered(constraint):
            if b.available() and (constraint is None
                                  or constraint.admits(b)):
                b.transport.grant_probe(window)   # see pick()
                self.stats.picks[b.name] += 1
                self.stats.replay_served += 1
                if self.events is not None:
                    self.events.emit(EV_REPLAY_SERVED, window=window,
                                     backend=b.name)
                return b
        self.stats.replay_dropped += 1
        if self.events is not None:
            self.events.emit(EV_REPLAY_DROPPED, window=window,
                             reason="no_backend")
        return None

    def expected_cost_per_escalation(self, default: float) -> float:
        """Price of the policy-preferred backend (healthy steady state) —
        the offline calibration's per-escalation cost estimate."""
        cands = self.candidates()
        cost = cands[0].cost_per_request if cands else None
        return default if cost is None else cost

    def shutdown(self, wait: bool = True) -> None:
        for b in self.backends:
            b.shutdown(wait=wait)
