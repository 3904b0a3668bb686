"""Cascade observability layer (DESIGN.md §9).

BiSupervised's value proposition is an operational trade-off — dollars
saved vs accuracy lost *per request* — so the runtime must be
inspectable at per-request granularity, not just through aggregate
``CascadeStats`` counters after the fact. This module is the one place
that visibility lives; every hook is no-op-cheap when observability is
disabled (the engine guards each stamp behind one ``is not None`` check
and allocates nothing per row).

``span(name, device=False)`` names a stretch of the serving and generate
paths on ``torch.profiler``'s clock, beside the card's operations. It
records **only while a profiler records**: its one check is torch's own
Python flag (``torch.autograd.profiler._is_profiler_enabled``), and with
the flag off it returns one shared no-op context, allocating nothing and
reading no clock. With the flag on it enters ``record_function(name)``,
which the trace holds on the thread that opened the profiler only (the
profiler records no other thread's host events), and on exit adds its
host seconds, from any thread, to the process-wide registry ``SPANS`` as
``span_seconds{span=name}``. ``device=True`` also records a pair of
timing events on the current CUDA stream, taken from a pool that reuses
them; the pair's elapsed time (the stream's time from the span's start
to its end, idle gaps between launches included) goes to
``span_device_seconds{span=name}`` once the stream has passed the end
event: span exits and reads of ``SPANS`` resolve the finished pairs, and
neither waits on the card. ``SPANS`` renders through ``snapshot`` and
``render_prometheus`` like any registry. ``spanned(name)`` wraps a whole
function in a span. The spans of the port, each on the thread that
calls its code unless named:

* ``cascade.window`` (scheduler): a window packed, served and handed
  back; in the overlapped modes one turn of the drain loop.
* ``cascade.dispatch`` (engine ``_dispatch``): the local tier and the
  gate launched, the triple's fetch started.
* ``cascade.gate_wait``: the gate triple landed (``fetch.wait()`` or
  the early-emit result).
* ``cascade.host_half``: the rest of ``_host_gate`` and all of
  ``_host_begin`` (policies, gather, cache, route, submit).
* ``cascade.remote_wait``: blocked on the remote tier (the synchronous
  ``call`` in the host half, ``_finalize``'s wait on a transport
  future).
* ``cascade.finalize``: scoring and dispositions after that wait.
* ``cascade.commit`` (engine ``_commit``).
* ``transport.window`` (``_call_with_retries``): at FIFO depth 1 on
  the caller's thread, else on a ``remote-transport`` pool thread.
* ``transport.attempt`` (``device=True``): one ``remote_apply``, on a
  ``remote-attempt`` pool thread.
* ``generate.prefill``, ``generate.graft``, ``generate.step``
  (``greedy_generate``): the prefill and the first token's pick; the
  decode cache made and grafted; one decode step and its token's pick.

The names avoid the prefixes ``bench.``, ``flash_`` and ``decode_``,
which the benchmark's trace reduction and kernel readers match on.

Three components behind one ``Observability`` facade:

* ``MetricsRegistry`` — counters, gauges and fixed-bucket histograms,
  snapshotable as JSON (``snapshot``) and Prometheus exposition text
  (``render_prometheus``). Hot-path publishers touch counters once per
  *window* (commit time); everything derivable from existing stats
  objects (escalation fraction, breaker state, controller EMA, cache
  hit ratio, per-backend inflight/cost/latency) is sampled lazily at
  snapshot time via registered collector callbacks, so steady-state
  serving pays nothing for gauges.

* ``TraceSink`` — a bounded buffer of per-request span timelines
  (enqueue → pack → dispatch → gate → route → remote-RTT or cache-hit
  → commit → hand-back) threaded through the engine's ``_InFlight``
  bookkeeping. Spans carry disposition, backend, realised $ cost and
  the gating threshold; ``write_jsonl`` emits one span per line and
  ``write_chrome_trace`` exports the Chrome ``trace_event`` format for
  perfetto / chrome://tracing.

* ``EventLog`` — a bounded, thread-safe log of state transitions that
  previously happened silently: breaker open/half-open/close, router
  failover/fail-back, replay ticket redemption, controller drift,
  deadline/policy downgrades. Every event carries a global sequence
  number (the ordering contract — emitters live on engine and pool
  threads), a monotonic timestamp, and the window id that triggered it.

Span stage glossary, metric names and the event schema are tabulated in
DESIGN.md §9; the future chaos bench asserts against the trace/event
output as ground truth.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from collections import Counter as _Counter
from collections import deque
from collections.abc import Callable
from typing import Any

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "EV_ADMISSION_DEGRADE",
    "EV_ADMISSION_SHED",
    "EV_BACKEND_AGREEMENT",
    "EV_BREAKER_CLOSE",
    "EV_BREAKER_HALF_OPEN",
    "EV_BREAKER_OPEN",
    "EV_CHAOS_BEGIN",
    "EV_CHAOS_END",
    "EV_CLUSTER_RECONCILE",
    "EV_CONTROLLER_DRIFT",
    "EV_CONTROLLER_UPDATE",
    "EV_DEADLINE_DOWNGRADE",
    "EV_POLICY_DOWNGRADE",
    "EV_REPLAY_DROPPED",
    "EV_REPLAY_PARKED",
    "EV_REPLAY_SERVED",
    "EV_ROUTER_FAILBACK",
    "EV_ROUTER_FAILOVER",
    "EV_STAGE_ANSWER",
    "EV_TIER_RECONCILE",
    "LATENCY_BUCKETS_S",
    "SPAN_STAGES",
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "Observability",
    "SPANS",
    "TraceSink",
    "span",
    "spanned",
]

# -- event names (DESIGN.md §9 event schema) --------------------------------
EV_BREAKER_OPEN = "breaker_open"
EV_BREAKER_HALF_OPEN = "breaker_half_open"
EV_BREAKER_CLOSE = "breaker_close"
EV_ROUTER_FAILOVER = "router_failover"
EV_ROUTER_FAILBACK = "router_failback"
EV_REPLAY_PARKED = "replay_parked"
EV_REPLAY_SERVED = "replay_served"
EV_REPLAY_DROPPED = "replay_dropped"
EV_CONTROLLER_DRIFT = "controller_drift"
EV_CONTROLLER_UPDATE = "controller_update"
EV_DEADLINE_DOWNGRADE = "deadline_downgrade"
EV_POLICY_DOWNGRADE = "policy_downgrade"
# chaos injection (DESIGN.md §10): episode activation markers — emitted
# by the ChaosRemote wrapper on the first call that observes the episode
# active / over, so cause (chaos_episode_begin) is always sequenced
# before effect (the breaker/failover events the faults trigger)
EV_CHAOS_BEGIN = "chaos_episode_begin"
EV_CHAOS_END = "chaos_episode_end"
# admission control (DESIGN.md §10): a request shed at submit (SHED
# disposition) or degraded to local-only under overload
EV_ADMISSION_SHED = "admission_shed"
EV_ADMISSION_DEGRADE = "admission_degrade"
# cluster scale-out (DESIGN.md §12): one event per ClusterBudgetController
# reconcile — carries the pooled threshold, per-replica targets and any
# replicas excluded as stale (blackout) this round
EV_CLUSTER_RECONCILE = "cluster_reconcile"
# N-tier hierarchy (DESIGN.md §13): per-commit attribution of which
# stage of a chained backend answered how many rows at what cost, the
# per-backend agreement-with-local EMA update, and one event per
# TieredBudgetController reconcile (per-hop targets re-centred on the
# global end-to-end budget)
EV_STAGE_ANSWER = "stage_answer"
EV_BACKEND_AGREEMENT = "backend_agreement"
EV_TIER_RECONCILE = "tier_reconcile"

# canonical span stage order (a span contains the subset that applies to
# its disposition; timestamps are nondecreasing in this order).
# "pack" and "join" are alternatives: windowed rows are packed into a
# microbatch, continuous-batching rows join a slot of the persistent
# batch (DESIGN.md §11); "emit" marks a trusted-local row surfaced at
# gate time by the in-kernel early emit, ahead of its window's commit
SPAN_STAGES = ("enqueue", "pack", "join", "dispatch", "gate", "route",
               "cache_hit", "remote", "commit", "emit", "handback")

# fixed histogram buckets for latency-shaped observations (seconds);
# +inf is implicit (the _count line covers it)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _series_key(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` is a bare ``+=`` — publishers update
    from one thread (the engine's commit half); cross-thread emitters go
    through the ``EventLog`` instead."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value; ``None`` means "no observation yet" and the
    series is omitted from snapshots (the empty-stats contract — a fresh
    runtime must not report a 0.0 latency it never measured)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float | None = None

    def set(self, v: float | None) -> None:
        self.value = None if v is None else float(v)


class Histogram:
    """Fixed-bucket histogram (cumulative counts at snapshot time)."""

    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets: tuple[float, ...] = LATENCY_BUCKETS_S):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.total += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Name+labels keyed registry of ``Counter``/``Gauge``/``Histogram``.

    ``register_collector(fn)`` defers derived gauges to snapshot time:
    ``fn(registry)`` runs at every ``snapshot()``/``render_prometheus()``
    and samples whatever live state it closed over — the serving hot
    path never touches a gauge.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], Counter] = {}
        self._gauges: dict[tuple[str, tuple], Gauge] = {}
        self._histograms: dict[tuple[str, tuple], Histogram] = {}
        self._collectors: list[Callable[[MetricsRegistry], None]] = []

    @staticmethod
    def _key(name: str, labels: dict[str, Any]) -> tuple[str, tuple]:
        return name, tuple(sorted((k, str(v)) for k, v in labels.items()))

    def counter(self, name: str, **labels: Any) -> Counter:
        key = self._key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = self._key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
                  **labels: Any) -> Histogram:
        key = self._key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(buckets))
        return h

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]
                           ) -> None:
        self._collectors.append(fn)

    def _collect(self) -> None:
        for fn in self._collectors:
            fn(self)

    def snapshot(self) -> dict[str, Any]:
        """JSON-able snapshot: ``{counters, gauges, histograms}`` keyed by
        ``name{label="value"}``. Gauges whose value is ``None`` (never
        observed) are ABSENT, not 0.0."""
        self._collect()
        counters = {_series_key(n, lb): c.value
                    for (n, lb), c in sorted(self._counters.items())}
        gauges = {_series_key(n, lb): g.value
                  for (n, lb), g in sorted(self._gauges.items())
                  if g.value is not None}
        hists = {}
        for (n, lb), h in sorted(self._histograms.items()):
            hists[_series_key(n, lb)] = {
                "buckets": {str(ub): c for ub, c in
                            zip(h.buckets, h.cumulative())},
                "count": h.total,
                "sum": h.sum,
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (``# TYPE`` headers, cumulative
        ``_bucket{le=...}`` histogram series)."""
        self._collect()
        lines: list[str] = []
        typed: set[str] = set()

        def header(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (n, lb), c in sorted(self._counters.items()):
            header(n, "counter")
            lines.append(f"{_series_key(n, lb)} {c.value}")
        for (n, lb), g in sorted(self._gauges.items()):
            if g.value is None:
                continue
            header(n, "gauge")
            lines.append(f"{_series_key(n, lb)} {g.value}")
        for (n, lb), h in sorted(self._histograms.items()):
            header(n, "histogram")
            cum = h.cumulative()
            for ub, c in zip(h.buckets, cum):
                key = _series_key(f"{n}_bucket",
                                  lb + (("le", f"{ub:g}"),))
                lines.append(f"{key} {c}")
            inf_key = _series_key(f"{n}_bucket", lb + (("le", "+Inf"),))
            lines.append(f"{inf_key} {h.total}")
            lines.append(f"{_series_key(n + '_sum', lb)} {h.sum}")
            lines.append(f"{_series_key(n + '_count', lb)} {h.total}")
        return "\n".join(lines) + "\n"


class EventLog:
    """Bounded, thread-safe structured event log.

    Each event is a dict ``{seq, ts, event, window, backend, ...}``:
    ``seq`` is a global monotonic counter assigned under the log's lock
    — the cross-thread ordering contract (breaker transitions land from
    transport pool threads while routing events land from the engine
    thread) — and ``ts`` comes from the injectable clock. The deque is
    bounded; ``dropped`` counts evicted-oldest events.
    """

    def __init__(self, capacity: int = 8192,
                 clock: Callable[[], float] = time.monotonic):
        from collections import deque
        self._events: Any = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._clock = clock
        self.total = 0

    def emit(self, event: str, *, window: int | None = None,
             backend: str | None = None, **fields: Any) -> dict:
        rec = {"event": event, "window": window, "backend": backend,
               **fields}
        with self._lock:
            rec["seq"] = self.total
            rec["ts"] = self._clock()
            self.total += 1
            self._events.append(rec)
        return rec

    @property
    def dropped(self) -> int:
        return self.total - len(self._events)

    def events(self, event: str | None = None,
               backend: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if event is not None:
            evs = [e for e in evs if e["event"] == event]
        if backend is not None:
            evs = [e for e in evs if e.get("backend") == backend]
        return evs

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(_Counter(e["event"] for e in self._events))

    def first_seq(self, event: str, backend: str | None = None
                  ) -> int | None:
        evs = self.events(event, backend)
        return evs[0]["seq"] if evs else None


class TraceSink:
    """Bounded buffer of per-request span timelines.

    A span is ``{uid, window, disposition, backend, cost, source,
    t_local_gate, stages: [[stage, ts], ...]}`` with stage timestamps
    nondecreasing in ``SPAN_STAGES`` order. The buffer is bounded
    (``dropped`` counts spans past capacity); ``write_jsonl`` dumps one
    span per line and ``write_chrome_trace`` exports Chrome
    ``trace_event`` JSON (one complete "X" slice per stage transition;
    ``tid`` is the engine window, so perfetto lanes show pipelining).
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = max(1, capacity)
        self._spans: list[dict] = []
        self._lock = threading.Lock()
        self.dropped = 0

    def emit(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
                return
            self._spans.append(span)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def write_jsonl(self, path: str) -> int:
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        return len(spans)

    def write_chrome_trace(self, path: str) -> int:
        """Chrome ``trace_event`` export (catapult / perfetto): each
        consecutive stage pair becomes one complete event named after
        the later stage (the segment that *ended* there)."""
        spans = self.spans()
        t0 = min((s["stages"][0][1] for s in spans if s["stages"]),
                 default=0.0)
        events = []
        for s in spans:
            stages = s["stages"]
            for (_, prev_ts), (stage, ts) in zip(stages, stages[1:]):
                events.append({
                    "name": stage,
                    "cat": s.get("disposition", ""),
                    "ph": "X",
                    "pid": 1,
                    "tid": s.get("window") or 0,
                    "ts": (prev_ts - t0) * 1e6,
                    "dur": max(ts - prev_ts, 0.0) * 1e6,
                    "args": {"uid": s.get("uid"),
                             "backend": s.get("backend"),
                             "cost": s.get("cost")},
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


class Observability:
    """Facade bundling the metrics registry, trace sink and event log.

    The engine, scheduler, router, transports and controller all hold a
    reference to (parts of) one ``Observability``; ``install(engine)``
    wires everything in one place so component hot paths only carry the
    ``is not None`` guard. Construct via ``ServeConfig(
    observability=True)`` / ``build_observability()`` in normal use.
    """

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 trace: TraceSink | None = None,
                 events: EventLog | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = trace
        self.events = events if events is not None else EventLog(clock=clock)

    @classmethod
    def enabled(cls, *, trace_capacity: int = 65536,
                event_capacity: int = 8192,
                clock: Callable[[], float] = time.monotonic
                ) -> "Observability":
        """Fully-enabled instance (metrics + trace + events)."""
        return cls(metrics=MetricsRegistry(),
                   trace=TraceSink(trace_capacity),
                   events=EventLog(event_capacity, clock=clock),
                   clock=clock)

    # -- wiring ---------------------------------------------------------
    def install(self, engine: Any) -> "Observability":
        """Attach to a ``CascadeEngine`` (runtime path): the engine
        stamps window stages and publishes commit-time counters; every
        backend transport, the router and the controller emit their
        state transitions into the shared event log; derived gauges are
        registered as snapshot-time collectors over the live stats."""
        engine.observability = self
        # one clock everywhere: event timestamps become comparable with
        # span stage stamps (ordering across threads still uses seq)
        self.events._clock = engine._clock
        if engine.router is not None:
            engine.router.attach_events(self.events)
        if engine.controller is not None:
            engine.controller.events = self.events
        self.metrics.register_collector(
            lambda reg: _collect_engine(reg, engine))
        return self


# -- spans on the profiler's timeline (see the module's docstring) ---------
# every span's seconds, from every thread, while a profiler records
SPANS = MetricsRegistry()
_NO_SPAN = contextlib.nullcontext()
_SPAN_LOCK = threading.Lock()
_PAIRS: deque = deque()         # (name, start, end) not yet resolved
_EVENTS: list = []              # timing events free for reuse
_RESOLVE_AT_EXIT = 4            # finished pairs a span exit resolves, at most


def _event() -> "torch.cuda.Event":
    try:
        return _EVENTS.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _resolve(limit: int | None) -> None:
    """Observe the oldest pairs whose end the stream has passed, up to
    ``limit``, and return their events to the pool; never waits. Called
    under ``_SPAN_LOCK``."""
    n = 0
    while _PAIRS and (limit is None or n < limit) and _PAIRS[0][2].query():
        name, start, end = _PAIRS.popleft()
        SPANS.histogram("span_device_seconds", span=name).observe(
            start.elapsed_time(end) * 1e-3)
        _EVENTS.extend((start, end))
        n += 1


class _Span:
    """A span while the profiler records (see ``span``)."""

    __slots__ = ("name", "device", "_rf", "_start", "_t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        # a thread that never touched CUDA has no device work to time
        self.device = device and torch.cuda.is_initialized()

    def __enter__(self) -> "_Span":
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        if self.device:
            self._start = _event()
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        dt = time.perf_counter() - self._t0
        if self.device:
            end = _event()
            end.record()
        self._rf.__exit__(exc_type, exc, tb)
        with _SPAN_LOCK:
            SPANS.histogram("span_seconds", span=self.name).observe(dt)
            if self.device:
                _PAIRS.append((self.name, self._start, end))
                _resolve(_RESOLVE_AT_EXIT)


def span(name: str, *, device: bool = False):
    """Context naming a stretch of work: a no-op unless ``torch.profiler``
    is recording, else a ``record_function(name)`` whose host seconds go
    to ``SPANS`` as ``span_seconds{span=name}``; with ``device`` also the
    seconds between a CUDA event pair on the current stream around it,
    as ``span_device_seconds{span=name}``."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, device)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _collect_device_spans(reg: MetricsRegistry) -> None:
    """Snapshot-time collector of ``SPANS``: resolves every finished
    pair (a pair the stream has not passed stays for a later read)."""
    with _SPAN_LOCK:
        _resolve(None)


SPANS.register_collector(_collect_device_spans)


def _collect_engine(reg: MetricsRegistry, engine: Any) -> None:
    """Snapshot-time collector: derived gauges sampled from the live
    engine/router/controller/cache stats (DESIGN.md §9 metric table).
    Ratios and latencies with an empty denominator are left unset —
    absent from the snapshot — instead of reporting 0.0."""
    st = engine.stats
    reg.gauge("cascade_inflight_windows").set(engine.inflight)
    if st.requests > 0:
        reg.gauge("cascade_escalation_fraction").set(st.escalation_fraction)
        reg.gauge("cascade_remote_fraction").set(st.remote_fraction)
    reg.gauge("cascade_mean_modelled_latency_seconds").set(st.mean_latency_s)
    reg.gauge("cascade_mean_wall_latency_seconds").set(st.mean_wall_latency_s)
    reg.gauge("cascade_p95_wall_latency_seconds").set(st.wall_percentile(95))
    if engine.router is not None:
        rs = engine.router.stats
        reg.gauge("router_failovers").set(rs.failovers)
        reg.gauge("router_unrouted").set(rs.unrouted)
        reg.gauge("router_replays_served").set(rs.replay_served)
        for b in engine.router.backends:
            lab = {"backend": b.name}
            state = {"closed": 0, "half_open": 1, "open": 2}.get(
                b.breaker.state, -1)
            reg.gauge("backend_breaker_state", **lab).set(state)
            reg.gauge("backend_breaker_opens", **lab).set(
                b.stats.breaker_opens)
            reg.gauge("backend_inflight_windows", **lab).set(b.inflight)
            reg.gauge("backend_remote_latency_ema_seconds", **lab).set(
                b.stats.latency_ema_s)
            reg.gauge("backend_mean_remote_latency_seconds", **lab).set(
                b.stats.mean_latency_s)
            u = st.per_backend.get(b.name)
            if u is not None:
                reg.gauge("backend_billed_dollars", **lab).set(u.cost)
                reg.gauge("backend_remote_calls", **lab).set(u.remote_calls)
    # per-backend/per-stage agreement-with-local EMA (DESIGN.md §13):
    # iterated over per_backend rather than router.backends because a
    # chained CascadeStage attributes to stage names the router never
    # sees as backends of its own
    for bname in sorted(st.per_backend, key=str):
        u = st.per_backend[bname]
        if u.agreement_ema is not None:
            reg.gauge("backend_agreement_ema", backend=str(bname)).set(
                u.agreement_ema)
    if engine.controller is not None:
        cs = engine.controller.state
        reg.gauge("controller_windows").set(cs.windows)
        reg.gauge("controller_ema_remote_fraction").set(cs.ema_fraction)
        reg.gauge("controller_rho").set(cs.rho)
        reg.gauge("controller_t_local").set(cs.t_local)
        reg.gauge("controller_t_remote").set(cs.t_remote)
        reg.gauge("controller_drift_events").set(cs.drift_events)
        reg.gauge("controller_last_psi").set(cs.last_psi)
        reg.gauge("controller_effective_target").set(cs.effective_target)
    if engine.cache is not None:
        cst = engine.cache.stats
        reg.gauge("cache_hit_ratio").set(cst.hit_rate)
        reg.gauge("cache_hits").set(cst.hits)
        reg.gauge("cache_misses").set(cst.misses)
        reg.gauge("cache_evictions").set(cst.evictions)
        reg.gauge("cache_cross_replica_hits").set(cst.cross_hits)
        reg.gauge("cache_entries").set(len(engine.cache))


class MetricsServer:
    """Stdlib HTTP scrape endpoint for a ``MetricsRegistry``.

    Serves the live registry over a daemon thread (DESIGN.md §9 follow-
    on: metrics over a real scrape endpoint instead of file dumps):

    * ``GET /metrics``      — Prometheus text exposition
      (``render_prometheus``; content type ``text/plain; version=0.0.4``)
    * ``GET /metrics.json`` — the JSON ``snapshot``
    * ``GET /healthz``      — liveness probe (``ok``)

    ``port=0`` binds an ephemeral port; the realised one is ``.port``.
    Collectors registered on the registry run at scrape time under the
    registry's own synchronisation, so scrapes ride alongside a live
    serve loop without touching its hot path. ``close()`` (or the
    context manager) shuts the listener down; request logging is
    suppressed — a scrape every few seconds must not spam the serve
    loop's stderr.
    """

    def __init__(self, metrics: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server

        registry = metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib casing
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = json.dumps(registry.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass

        self.metrics = metrics
        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-server", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.close()
