"""Horizontal scale-out: N engines behind one logical cascade
(DESIGN.md §12).

The paper prices the cascade per request; the deployment shape it
implies (CheapET-3: a fleet of cheap local predictors gating one
metered remote API) prices it per *fleet*. A single engine already
holds a remote-fraction/$ budget, attributes cache hits to filling
backends and sheds under overload — this module lifts all three to N
replicas without giving up the repo's determinism contract:

* ``SharedResponseCache`` — one logical content-keyed response store
  over N engine-facing views, with a **single-fill ownership rule**:
  the first replica to miss a key claims it and performs the remote
  call; every other replica either waits for the fill or serves the
  hit later at $0 with the filler's backend attribution. Fills are
  published on a seq-ordered update feed, so any merge order of the
  feed reconstructs the same store (per key there is exactly one
  record).

* ``ClusterBudgetController`` — periodically pools the per-replica
  EMA/PI controller states (rolling 1st-level score buffers, traffic
  deltas) into one global remote-fraction or dollar budget, places a
  single pooled score threshold, and pushes each replica's *demand* at
  that threshold back down as its new target. The traffic-weighted
  mean of the pushed targets equals the global target by construction,
  so the fleet budget holds even when one replica sees only hard
  traffic and another only easy. Replicas with zero traffic since the
  last reconcile (blackout) are excluded and degrade to the base
  per-replica budget; iteration is sorted by replica name everywhere,
  so registration/merge order never changes the result.

* ``admission_scale`` — the cluster shed rule: each replica's soft
  admission watermark (DESIGN.md §10) scales with its current budget
  share, so a replica the reconciler squeezed sheds earlier and one
  granted headroom rides closer to its hard bound.

* ``ClusterHarness`` — an in-process cluster: N ``CascadeEngine``
  replicas (each on its own worker thread, with per-replica-labelled
  metrics/events over one shared registry/log) against one shared
  router/chaos schedule and one virtual clock. Replicas flush in a
  seeded-permutation merge order, serialized turn by turn, so a double
  run is bit-identical — the property the cluster bench gates in CI.
"""

from __future__ import annotations

import functools
import queue
import random
import threading
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.runtime.cache import (CacheStats, _row, content_key,
                                       content_keys)
from repro_torch.runtime.chaos import VirtualClock
from repro_torch.runtime.controller import AdaptiveController
from repro_torch.runtime.observability import (EV_CLUSTER_RECONCILE,
                                               EventLog, MetricsRegistry,
                                               Observability)

__all__ = [
    "CacheUpdate",
    "ClusterBudgetConfig",
    "ClusterBudgetController",
    "ClusterBudgetState",
    "ClusterHarness",
    "ClusterReplica",
    "ReplicaCacheView",
    "SharedCacheStats",
    "SharedResponseCache",
    "cluster_billing",
]


# --------------------------------------------------------------------------
# shared response cache: single-fill protocol over N replica views
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheUpdate:
    """One record of the seq-ordered fill feed: replica ``replica``
    filled ``key`` from backend ``source``. Exactly one record exists
    per key under the single-fill rule (absent evictions), so applying
    the feed in ANY order reconstructs the same store."""
    seq: int
    key: bytes
    value: np.ndarray
    source: str | None
    replica: str


@dataclass
class SharedCacheStats:
    fills: int = 0              # first-fill puts (feed records)
    # a put on an already-filled key by a DIFFERENT replica: evidence of
    # a cross-replica double fetch — the single-fill invariant the
    # cluster bench gates on is duplicate_fills == 0
    duplicate_fills: int = 0
    # a re-put by the SAME replica: duplicate rows inside one window
    # (both rode the one remote call that filled the key) — benign
    redundant_puts: int = 0
    waits: int = 0              # lookups that blocked on a peer's fill
    steals: int = 0             # claims taken over after a wait timeout
    releases: int = 0           # claims dropped by release_unfilled
    evictions: int = 0          # LRU evictions (capacity pressure)


class SharedResponseCache:
    """One logical content-keyed response store shared by N replicas.

    Single-fill ownership (DESIGN.md §12): a ``lookup`` miss on an
    unclaimed key *claims* it for the looking replica, which then
    performs the remote call and ``put``s the value. A concurrent
    lookup of a claimed key on another replica blocks (bounded by
    ``wait_s``) until the owner's fill lands, then serves the hit with
    the owner's backend attribution — the same content is never fetched
    remotely twice. A replica whose fill failed calls
    ``release_unfilled`` so waiting peers can re-claim.

    The store is bounded LRU like ``RemoteResponseCache``; pending
    claims are never evicted. All state transitions happen under one
    condition variable, and fills append to a seq-ordered ``feed``.
    """

    def __init__(self, capacity: int = 4096, *,
                 key_fn: Callable = content_key,
                 key_batch_fn: Callable | None = None,
                 wait_s: float = 30.0):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self.key_fn = key_fn
        if key_batch_fn is None and key_fn is content_key:
            key_batch_fn = content_keys
        self.key_batch_fn = key_batch_fn
        self.wait_s = wait_s
        self.stats = SharedCacheStats()
        self.feed: list[CacheUpdate] = []
        self._cond = threading.Condition()
        # key -> (value, source backend, filling replica)
        self._store: OrderedDict[
            bytes, tuple[np.ndarray, str | None, str]] = OrderedDict()
        self._pending: dict[bytes, str] = {}    # key -> owning replica
        self._views: dict[str, ReplicaCacheView] = {}

    def view(self, replica: str, *, key_fn: Callable | None = None,
             key_batch_fn: Callable | None = None) -> "ReplicaCacheView":
        """The engine-facing cache handle for one replica (duck-types
        ``RemoteResponseCache``). Key functions default to the shared
        store's; per-view overrides must agree across replicas or keys
        will not collide."""
        if replica in self._views:
            return self._views[replica]
        v = ReplicaCacheView(self, replica,
                             key_fn=key_fn or self.key_fn,
                             key_batch_fn=(key_batch_fn
                                           or self.key_batch_fn))
        self._views[replica] = v
        return v

    def __len__(self) -> int:
        with self._cond:
            return len(self._store)

    def _lookup(self, replica: str, key: bytes
                ) -> tuple[np.ndarray, str | None, str] | None:
        """Hit -> ``(value, source, filler_replica)``; miss -> None and
        the key is claimed by ``replica`` (single-fill). Blocks while a
        *different* replica holds the claim; the owner's own re-lookup
        (duplicate rows inside one window) misses again immediately."""
        with self._cond:
            while True:
                ent = self._store.get(key)
                if ent is not None:
                    self._store.move_to_end(key)
                    return ent
                owner = self._pending.get(key)
                if owner is None or owner == replica:
                    self._pending[key] = replica
                    return None
                self.stats.waits += 1
                if not self._cond.wait(timeout=self.wait_s):
                    # liveness valve: the owner stalled past wait_s —
                    # steal the claim and refetch rather than hang
                    self.stats.steals += 1
                    self._pending[key] = replica
                    return None

    def _fill(self, replica: str, key: bytes, value: np.ndarray,
              source: str | None) -> bool:
        """Publish a fill. First fill per key wins (and is the feed
        record); a duplicate fill is counted and DISCARDED so every
        replica keeps serving the identical first value."""
        with self._cond:
            ent = self._store.get(key)
            if ent is not None:
                if ent[2] == replica:
                    self.stats.redundant_puts += 1
                else:
                    self.stats.duplicate_fills += 1
                self._store.move_to_end(key)
                return False
            self._store[key] = (np.asarray(value), source, replica)
            self._pending.pop(key, None)
            self.feed.append(CacheUpdate(len(self.feed), key,
                                         self._store[key][0], source,
                                         replica))
            self.stats.fills += 1
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.stats.evictions += 1
            self._cond.notify_all()
            return True

    def release_unfilled(self, replica: str) -> int:
        """Drop every claim ``replica`` still holds (its fills failed or
        were shed) so waiting peers can re-claim. The harness calls this
        after each replica's flush turn; transports call it on teardown."""
        with self._cond:
            stale = [k for k, o in self._pending.items() if o == replica]
            for k in stale:
                del self._pending[k]
            if stale:
                self.stats.releases += len(stale)
                self._cond.notify_all()
            return len(stale)

    def clear(self) -> None:
        with self._cond:
            self._store.clear()
            self._pending.clear()
            self._cond.notify_all()

    @staticmethod
    def materialize(feed: list[CacheUpdate]
                    ) -> dict[bytes, tuple[bytes, str | None, str]]:
        """Reduce a fill feed to ``{key: (value bytes, source,
        replica)}``. First record per key wins — with single-fill intact
        there IS only one, so any permutation of ``feed`` produces the
        identical mapping (the determinism property tests assert)."""
        out: dict[bytes, tuple[bytes, str | None, str]] = {}
        for u in sorted(feed, key=lambda u: u.seq):
            out.setdefault(u.key,
                           (u.value.tobytes(), u.source, u.replica))
        return out


class ReplicaCacheView:
    """Per-replica handle onto a ``SharedResponseCache``; duck-types the
    ``RemoteResponseCache`` surface the engine uses (``stats``,
    ``keys_for``, ``lookup``, ``get``, ``put``, ``clear``, ``len``).
    ``stats`` counts this replica's traffic; ``stats.cross_hits`` counts
    hits served from entries a *different* replica filled."""

    def __init__(self, shared: SharedResponseCache, replica: str, *,
                 key_fn: Callable = content_key,
                 key_batch_fn: Callable | None = None):
        self.shared = shared
        self.replica = replica
        self.key_fn = key_fn
        if key_batch_fn is None and key_fn is content_key:
            key_batch_fn = content_keys
        self.key_batch_fn = key_batch_fn
        self.stats = CacheStats()

    def keys_for(self, batch: Any, rows: int) -> list[bytes]:
        if self.key_batch_fn is not None:
            return self.key_batch_fn(batch, rows)
        return [self.key_fn(_row(batch, i)) for i in range(rows)]

    def lookup(self, key: bytes) -> tuple[np.ndarray, str | None] | None:
        ent = self.shared._lookup(self.replica, key)
        if ent is None:
            self.stats.misses += 1
            return None
        value, source, filler = ent
        self.stats.hits += 1
        if filler != self.replica:
            self.stats.cross_hits += 1
        return value, source

    def get(self, key: bytes) -> np.ndarray | None:
        hit = self.lookup(key)
        return None if hit is None else hit[0]

    def put(self, key: bytes, value: np.ndarray,
            source: str | None = None) -> None:
        self.shared._fill(self.replica, key, value, source)

    def clear(self) -> None:
        self.shared.clear()

    def __len__(self) -> int:
        return len(self.shared)


# --------------------------------------------------------------------------
# cluster budget reconcile
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterBudgetConfig:
    """Knobs of the cluster-level budget reconcile (DESIGN.md §12)."""
    target_remote_fraction: float = 0.2   # global fraction budget
    cost_budget_per_request: float | None = None   # global $; None=frac
    interval_s: float = 2.0               # reconcile cadence
    target_floor: float = 0.02            # min per-replica target pushed
    min_pooled_scores: int = 64           # below -> degraded mode
    share_min: float = 0.25               # admission_scale clamp
    share_max: float = 4.0


@dataclass
class ClusterBudgetState:
    reconciles: int = 0
    mode: str = "warmup"          # warmup | pooled | degraded
    tau: float | None = None      # pooled score threshold placed
    global_target: float | None = None    # effective global fraction
    global_ema_fraction: float | None = None  # traffic-weighted realised
    targets: dict[str, float] = field(default_factory=dict)
    stale: tuple[str, ...] = ()   # replicas excluded this round
    last_now: float | None = None


class ClusterBudgetController:
    """Reconciles N per-replica EMA/PI controllers into one global
    budget and pushes re-weighted targets back down.

    Pooled mode: concatenate every live replica's rolling score buffer
    (buffer sizes are traffic-proportional, so the pool is the fleet's
    score distribution), place the global threshold ``tau`` at the
    target quantile, and push each replica the fraction of *its own*
    scores below ``tau``. The traffic-weighted mean of the pushed
    targets equals the global target by construction — the budget holds
    under skew while hard-traffic replicas legitimately spend more.

    Degraded mode (staleness bound = one reconcile interval): replicas
    with zero eligible traffic since the last reconcile are excluded
    from the pool and reset to the base target, as is everyone when
    fewer than two replicas are live or the pool is too thin — per-
    replica budgets, never silent drops.

    Dollar mode: with ``cost_budget_per_request`` set, the global
    fraction target is re-derived first from the fleet-blended $ per
    escalation (traffic-weighted over live replicas), then the same
    pooled reallocation runs; per-replica controllers stay in fraction
    mode and the cluster holds the dollar budget.

    All iteration is sorted by replica name: registration order and
    reconcile merge order cannot change any output bit.
    """

    def __init__(self, config: ClusterBudgetConfig | None = None):
        self.config = config if config is not None else ClusterBudgetConfig()
        self.state = ClusterBudgetState()
        self._replicas: dict[str, AdaptiveController] = {}
        self._last_requests: dict[str, int] = {}
        self.events: Any = None     # raw shared EventLog (cluster scope)

    def register(self, name: str, controller: AdaptiveController) -> None:
        if name in self._replicas:
            raise ValueError(f"duplicate replica name {name!r}")
        self._replicas[name] = controller
        self._last_requests[name] = controller.lifetime_requests
        self.state.targets[name] = self.config.target_remote_fraction

    def names(self) -> list[str]:
        return sorted(self._replicas)

    def target(self, name: str) -> float:
        return self.state.targets.get(
            name, self.config.target_remote_fraction)

    def admission_scale(self, name: str) -> float:
        """This replica's budget share relative to the global target —
        the scheduler's soft watermark multiplier (cluster shed rule,
        DESIGN.md §12). 1.0 until the first reconcile."""
        cfg = self.config
        base = self.state.global_target or cfg.target_remote_fraction
        if base <= 0.0:
            return 1.0
        scale = self.target(name) / base
        return float(min(max(scale, cfg.share_min), cfg.share_max))

    def _effective_target(self, live: list[str],
                          weights: dict[str, int]) -> float:
        cfg = self.config
        target = cfg.target_remote_fraction
        if cfg.cost_budget_per_request is None:
            return target
        num = den = 0.0
        for name in live:
            c = self._replicas[name].state.ema_cost_per_escalation
            if c is not None:
                num += weights[name] * c
                den += weights[name]
        if den == 0.0:
            return target
        blended = num / den
        if blended <= 0.0:
            return 1.0      # free escalations: the $ budget never binds
        return float(np.clip(
            cfg.cost_budget_per_request / blended, 0.0, 1.0))

    def reconcile(self, now: float) -> ClusterBudgetState:
        """One reconcile pass: weigh replicas by eligible-traffic delta,
        pool live score buffers, place ``tau``, push targets. Returns
        (and keeps) the new state; emits one ``cluster_reconcile``
        event when an event log is attached."""
        cfg, st = self.config, self.state
        live: list[str] = []
        weights: dict[str, int] = {}
        for name in self.names():
            total = self._replicas[name].lifetime_requests
            delta = total - self._last_requests[name]
            self._last_requests[name] = total
            weights[name] = delta
            if delta > 0:
                live.append(name)
        target = self._effective_target(live, weights)
        scores = {name: self._replicas[name].recent_scores()
                  for name in live}
        pooled_n = sum(s.size for s in scores.values())
        targets: dict[str, float] = {}
        tau: float | None = None
        if len(live) >= 2 and pooled_n >= cfg.min_pooled_scores:
            mode = "pooled"
            pool = np.concatenate([scores[n] for n in live])
            tau = float(np.quantile(pool, target))
            for name in live:
                s = scores[name]
                d = float(np.mean(s < tau)) if s.size else target
                targets[name] = float(np.clip(d, cfg.target_floor, 1.0))
        else:
            mode = "degraded"
            for name in live:
                targets[name] = target
        for name in self.names():
            if name not in targets:     # stale (blackout) -> base budget
                targets[name] = cfg.target_remote_fraction
        for name in self.names():
            self._replicas[name].retarget(targets[name])
        # traffic-weighted realised fraction (telemetry + bench check)
        num = den = 0.0
        for name in self.names():
            ctrl = self._replicas[name]
            if ctrl.state.windows > 0 and ctrl.lifetime_requests > 0:
                num += ctrl.lifetime_requests * ctrl.state.ema_fraction
                den += ctrl.lifetime_requests
        st.reconciles += 1
        st.mode = mode
        st.tau = tau
        st.global_target = target
        st.global_ema_fraction = (num / den) if den else None
        st.targets = targets
        st.stale = tuple(n for n in self.names() if n not in live)
        st.last_now = now
        if self.events is not None:
            self.events.emit(
                EV_CLUSTER_RECONCILE, window=st.reconciles, mode=mode,
                tau=tau, global_target=target,
                global_ema_fraction=st.global_ema_fraction,
                targets={n: targets[n] for n in self.names()},
                stale=list(st.stale), now=now)
        return st

    def install_metrics(self, registry: MetricsRegistry) -> None:
        """Register a snapshot-time collector exporting per-replica
        targets and cluster reconcile telemetry."""
        registry.register_collector(self._collect)

    def _collect(self, reg: MetricsRegistry) -> None:
        st = self.state
        reg.gauge("cluster_reconciles").set(st.reconciles)
        reg.gauge("cluster_global_target").set(st.global_target)
        reg.gauge("cluster_global_ema_remote_fraction").set(
            st.global_ema_fraction)
        reg.gauge("cluster_stale_replicas").set(len(st.stale))
        for name in self.names():
            reg.gauge("cluster_target_remote_fraction",
                      replica=name).set(self.target(name))


# --------------------------------------------------------------------------
# per-replica observability proxies (shared registry/log, labelled)
# --------------------------------------------------------------------------

class _ReplicaMetrics:
    """``MetricsRegistry`` facade that stamps ``replica=<name>`` onto
    every series; collectors registered through it run against the
    proxy, so derived gauges label themselves too."""

    def __init__(self, registry: MetricsRegistry, replica: str):
        self._registry = registry
        self.replica = replica

    def counter(self, name: str, **labels: Any):
        return self._registry.counter(name, replica=self.replica,
                                      **labels)

    def gauge(self, name: str, **labels: Any):
        return self._registry.gauge(name, replica=self.replica, **labels)

    def histogram(self, name: str, buckets=None, **labels: Any):
        if buckets is None:
            return self._registry.histogram(
                name, replica=self.replica, **labels)
        return self._registry.histogram(name, buckets,
                                        replica=self.replica, **labels)

    def register_collector(self, fn: Callable) -> None:
        self._registry.register_collector(
            functools.partial(self._run_collector, fn))

    def _run_collector(self, fn: Callable, _reg: MetricsRegistry) -> None:
        fn(self)

    def snapshot(self) -> dict:
        return self._registry.snapshot()

    def render_prometheus(self) -> str:
        return self._registry.render_prometheus()


class _ReplicaEvents:
    """``EventLog`` facade stamping ``replica=<name>`` onto every emit;
    reads pass through to the shared log (global seq order preserved)."""

    def __init__(self, log: EventLog, replica: str):
        self._log = log
        self.replica = replica

    @property
    def _clock(self):
        return self._log._clock

    @_clock.setter
    def _clock(self, clock) -> None:
        self._log._clock = clock

    def emit(self, event: str, *, window: int | None = None,
             backend: str | None = None, **fields: Any) -> dict:
        fields.setdefault("replica", self.replica)
        return self._log.emit(event, window=window, backend=backend,
                              **fields)

    def events(self, event: str | None = None,
               backend: str | None = None) -> list[dict]:
        return self._log.events(event, backend)

    def counts(self) -> dict[str, int]:
        return self._log.counts()

    def first_seq(self, event: str, backend: str | None = None
                  ) -> int | None:
        return self._log.first_seq(event, backend)

    @property
    def dropped(self) -> int:
        return self._log.dropped

    @property
    def total(self) -> int:
        return self._log.total


# --------------------------------------------------------------------------
# in-process cluster harness
# --------------------------------------------------------------------------

class _Worker(threading.Thread):
    """Dedicated per-replica worker: the harness funnels every engine
    interaction for a replica through its thread (production affinity),
    but serializes turns, so determinism is by construction."""

    def __init__(self, name: str):
        super().__init__(name=f"replica-{name}", daemon=True)
        self._jobs: queue.Queue = queue.Queue()
        self.start()

    def run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["result"] = fn()
            except Exception as exc:        # surfaced in run_sync
                box["error"] = exc
            done.set()

    def run_sync(self, fn: Callable[[], Any]) -> Any:
        box: dict[str, Any] = {}
        done = threading.Event()
        self._jobs.put((fn, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def stop(self) -> None:
        self._jobs.put(None)
        self.join(timeout=5.0)


@dataclass
class ClusterReplica:
    """One replica's runtime stack inside a ``ClusterHarness``."""
    name: str
    engine: Any
    scheduler: Any
    controller: AdaptiveController
    cache: ReplicaCacheView | None
    worker: _Worker


class ClusterHarness:
    """N ``CascadeEngine`` replicas behind one logical cascade.

    Shared across replicas: the remote router (and any chaos schedule
    wrapped around it), the response store (``SharedResponseCache``),
    the budget reconciler, the metrics registry, the event log and the
    clock. Per replica: engine, scheduler (with the cluster admission
    share wired), adaptive controller, cache view, worker thread, and
    ``replica=<name>`` labels on every metric/event it emits. Fleet-
    scope emitters (router, backend transports, chaos markers,
    reconcile events) write to the raw shared log, unlabelled.

    ``flush()`` drains replicas one at a time in a seeded-permutation
    merge order — adversarial, but deterministic given the seed — and
    runs the budget reconcile on cadence. Two runs with identical
    inputs, seeds and clock advances are bit-identical (the cluster
    bench double-runs and gates on it).

    Every replica's engine runs its local tier and gate on ``device``
    (default ``"cuda"``; a missing GPU raises unless the caller asks for
    ``"cpu"``). The replicas share the device's default stream: their
    turns are serialized, and a remote tier's kernels launch from the
    shared router's transport threads.
    """

    def __init__(self, config: Any, local_apply: Callable, *,
                 transport: Any, fallback: Callable | None = None,
                 clock: Callable[[], float] | None = None, seed: int = 0,
                 reconcile_interval_s: float = 2.0,
                 cache_key_fn: Callable | None = None,
                 cache_key_batch_fn: Callable | None = None,
                 cluster_config: ClusterBudgetConfig | None = None,
                 device: Any = "cuda"):
        from repro_torch.serving.engine import CascadeEngine
        from repro_torch.serving.scheduler import MicrobatchScheduler
        if config.replicas < 1:
            raise ValueError("config.replicas must be >= 1")
        if config.build_controller() is None:
            raise ValueError("cluster needs adaptive=True (the reconcile "
                             "re-targets per-replica controllers)")
        self.config = config
        self.router = transport
        self._clock = clock if clock is not None else VirtualClock()
        self._rng = random.Random(seed)
        self.reconcile_interval_s = reconcile_interval_s
        self._last_reconcile = self._clock()
        # shared observability: one registry + one seq-ordered log
        self.metrics: MetricsRegistry | None = None
        self.events: EventLog | None = None
        if config.observability:
            self.metrics = MetricsRegistry()
            self.events = EventLog(config.event_capacity,
                                   clock=self._clock)
        # shared response store (single-fill protocol)
        self.shared_cache: SharedResponseCache | None = None
        if config.cache_size > 0:
            self.shared_cache = SharedResponseCache(
                config.cache_size,
                key_fn=cache_key_fn or content_key,
                key_batch_fn=cache_key_batch_fn)
        # cluster budget reconciler
        if cluster_config is None:
            cluster_config = ClusterBudgetConfig(
                target_remote_fraction=config.remote_fraction_budget,
                cost_budget_per_request=config.cost_budget,
                interval_s=reconcile_interval_s)
        self.cluster = ClusterBudgetController(cluster_config)
        self.cluster.events = self.events
        if self.metrics is not None:
            self.cluster.install_metrics(self.metrics)
        # one mesh for every replica (same devices; DESIGN.md §12)
        mesh = None
        if config.data_parallel:
            from repro_torch.launch.mesh import make_serving_mesh
            mesh = make_serving_mesh(device)
        self.replicas: OrderedDict[str, ClusterReplica] = OrderedDict()
        for i in range(config.replicas):
            name = f"r{i}"
            controller = config.build_controller()
            view = (self.shared_cache.view(name)
                    if self.shared_cache is not None else None)
            obs = None
            if config.observability:
                obs = Observability(
                    metrics=_ReplicaMetrics(self.metrics, name),
                    events=_ReplicaEvents(self.events, name))
            engine = CascadeEngine.from_config(
                config, local_apply, transport=transport,
                controller=controller, cache=view, observability=obs,
                mesh=mesh, clock=self._clock, device=device)
            sched = MicrobatchScheduler.from_config(
                engine, config, fallback=fallback,
                admission_share=functools.partial(
                    self.cluster.admission_scale, name))
            self.cluster.register(name, controller)
            self.replicas[name] = ClusterReplica(
                name, engine, sched, controller, view, _Worker(name))
        # per-replica installs each re-pointed the shared router at
        # their labelled proxy (last one wins) — the router and its
        # transports are fleet-scope, so re-attach the raw log
        if self.events is not None and self.router is not None \
                and hasattr(self.router, "attach_events"):
            self.router.attach_events(self.events)
        self._closed = False

    # -- driving -------------------------------------------------------
    @property
    def names(self) -> list[str]:
        return list(self.replicas)

    def replica(self, name: str) -> ClusterReplica:
        return self.replicas[name]

    def submit(self, replica: str, request: Any) -> Any:
        """Enqueue one request on a replica (its worker thread runs the
        admission decision). Returns the immediate SHED response when
        admission refuses it, else None."""
        rep = self.replicas[replica]
        return rep.worker.run_sync(
            functools.partial(rep.scheduler.submit, request))

    def flush(self, *, reconcile: bool = True
              ) -> dict[str, list[Any]]:
        """Drain every replica once, in a fresh seeded-permutation merge
        order, releasing unfilled cache claims after each turn; then
        reconcile the cluster budget if the cadence is due. Returns
        ``{replica: [responses]}`` (insertion order = merge order)."""
        out: dict[str, list[Any]] = {}
        order = self._rng.sample(self.names, len(self.replicas))
        for name in order:
            rep = self.replicas[name]
            out[name] = rep.worker.run_sync(rep.scheduler.flush)
            if self.shared_cache is not None:
                self.shared_cache.release_unfilled(name)
        if reconcile:
            self.maybe_reconcile()
        return out

    def maybe_reconcile(self, now: float | None = None
                        ) -> ClusterBudgetState | None:
        """Run the budget reconcile when the cadence interval elapsed
        (the staleness bound of DESIGN.md §12); None when not due."""
        now = self._clock() if now is None else now
        if now - self._last_reconcile < self.reconcile_interval_s:
            return None
        self._last_reconcile = now
        return self.cluster.reconcile(now)

    # -- aggregation ---------------------------------------------------
    def global_billing(self) -> dict[str, Any]:
        """Fleet-level billing: the per-replica ``CascadeStats`` summed
        in sorted replica order (replica-order invariant)."""
        return cluster_billing(
            {n: r.engine.stats for n, r in self.replicas.items()})

    def close(self, wait: bool = True) -> None:
        """Drain every replica, then shut engines down (the shared
        router's shutdown is idempotent across replicas) and stop the
        worker threads."""
        if self._closed:
            return
        self._closed = True
        self.flush(reconcile=False)
        for name in self.names:
            rep = self.replicas[name]
            rep.worker.run_sync(
                functools.partial(rep.engine.close, wait))
            rep.worker.stop()


def cluster_billing(stats_by_replica: dict[str, Any]) -> dict[str, Any]:
    """Aggregate per-replica ``CascadeStats`` into fleet totals.

    Iterates replicas (and their per-backend slices) in sorted-name
    order so float accumulation is independent of dict insertion /
    merge order — the property the permutation tests pin down. Returns
    ``{"billing": {field: total}, "per_backend": {name: {...}}}`` over
    exactly the ``BILLING_FIELDS`` contract.
    """
    from repro_torch.serving.engine import BILLING_FIELDS
    billing: dict[str, Any] = dict.fromkeys(BILLING_FIELDS, 0)
    per_backend: dict[str, dict[str, Any]] = {}
    for name in sorted(stats_by_replica):
        st = stats_by_replica[name]
        for f in BILLING_FIELDS:
            billing[f] = billing[f] + getattr(st, f)
        for bname in sorted(st.per_backend):
            u = st.per_backend[bname]
            agg = per_backend.setdefault(bname, {
                "remote_calls": 0, "cache_hits": 0,
                "transport_failures": 0, "cost": 0.0,
                "remote_latency_s": 0.0})
            agg["remote_calls"] += u.remote_calls
            agg["cache_hits"] += u.cache_hits
            agg["transport_failures"] += u.transport_failures
            agg["cost"] += u.cost
            agg["remote_latency_s"] += u.remote_latency_s
    return {"billing": billing, "per_backend": per_backend}
