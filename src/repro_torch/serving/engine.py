"""Cascade serving engine — BiSupervised as a two-tier production runtime.

The engine composes:
  * a LOCAL tier: cheap classifier (surrogate) evaluated for every request,
  * a 1st-level supervisor on the local logits,
  * escalation to a REMOTE tier — either a fused in-jit callable (offline /
    trusted deployments) or a fault-aware ``repro_torch.runtime`` transport /
    multi-backend router with caching and an online budget controller
    (DESIGN.md §2-§4, §6),
  * a 2nd-level supervisor on the remote metadata,
  * per-request cost/latency accounting mirroring the paper's billing
    model (Table 7 / §5.6) — padded scheduler rows are never billed.

Three serve paths (DESIGN.md §2, §5):
  * fused     — ``make_cascade_step``: local + remote in one jitted step
    with a static escalation capacity k (the seed behaviour; remote tier
    is an infallible callable).
  * runtime   — local tier jitted behind the fused ``confidence_gate``
    kernel (only the compact (conf, pred, idx) triple crosses the host
    boundary), escalated sub-batch routed host-side through
    ``RemoteResponseCache`` -> ``RemoteTransport``; failed windows degrade
    to the REJECTED/fallback path; an ``AdaptiveController`` retunes
    ``t_local``/``t_remote``/capacity per control window.
  * pipelined — the runtime path split at the transport boundary:
    ``begin_serve`` dispatches local compute + non-blocking remote
    submission, ``complete_next`` drains in-flight windows strictly in
    submission order, so batch i+1's local tier overlaps batch i's remote
    round trip while accounting and controller observations stay
    deterministic.
  * streaming — the pipelined path with per-request completion
    (DESIGN.md §7): ``complete_ready``/``stream`` finalize windows the
    moment their remote futures resolve (out of submission order when
    thresholds are static), while accounting still COMMITS strictly in
    submission order — responses, billing, per-backend attribution and
    controller updates are bitwise-identical to the FIFO drain.

Device-overlap double buffering (DESIGN.md §7): ``begin_serve`` only
DISPATCHES batch i's local forward; the host half (``device_get`` of the
gate triple, cache lookups, routing, remote submission) runs when batch
i+1 begins — so the accelerator computes batch i+1 while batch i's
escalations cross the host boundary. ``flush_dispatch`` unparks the final
window once no more begins are coming.

Per-request policy (DESIGN.md §8): every serve path accepts one
``RequestPolicy`` per genuine row (deadline SLA, cost cap, routing hint,
escalation override). The host half enforces them before any cache or
transport work — deadline-infeasible escalations downgrade to the local
prediction with the ``DEADLINE_LOCAL`` disposition instead of blowing
the SLA — and every result row carries ``disposition``/``backend``/
``cost`` so billing attribution surfaces at the API boundary. The
engine (like the scheduler and router) is constructed from a single
``ServeConfig`` facade via ``from_config``; the keyword constructor
remains as the low-level composition-root API (tests, bespoke wiring).

Port notes (PyTorch on one GPU): the local tier and its gate run on the
engine's ``device`` (default ``"cuda"``; a missing GPU raises unless the
caller asks for ``"cpu"``). The engine moves the scheduler's numpy local
batch there, with ``t_local``/``n_valid`` as 0-d device tensors. The
gate triple comes back through ``kernels.gate_fetch``: a pinned
non-blocking copy queued at dispatch right behind the gate, with an event
recorded after it, which the host half waits on. So the copy never waits
behind a remote prefill that a transport thread queues later.
Remote logits are scored on the host as CPU tensors. ``jax.jit`` has no
counterpart: the steps are plain callables. With a serving ``mesh``
(``launch.mesh.make_serving_mesh``; ``data_parallel``) the gated local
step runs its forward on each ``data`` rank's rows as DTensors and
gathers the window before the gate (``launch.sharding
.shard_local_step``), so what is served does not change.

Early emit (DESIGN.md §11): with ``early_emit`` on, an ``Emitter``
thread waits on each window's event and lands the triple in
``gate_result(seq)`` the moment the copy completes, waking the streaming
drain; the host half takes it from there, or waits on the event itself
when it comes first. ``"auto"`` (what ``from_config`` passes for
``batching="continuous"``) arms it exactly when the engine's device is
CUDA, whose dispatch is asynchronous as the TPU's is.

Observability (DESIGN.md §9): construct with ``observability=`` (or
``ServeConfig(observability=True)``) and the engine stamps a per-window
stage timeline into ``_InFlight.tr`` (dispatch → gate → route → remote →
commit), publishes commit-time counters into the metrics registry, and
emits downgrade events; the scheduler turns window stamps into one span
per request at hand-back. Every hook is guarded by a single
``is not None`` test, so the disabled mode adds zero per-row work.

Multi-remote routing (DESIGN.md §6): the runtime/pipelined paths accept a
``RemoteRouter`` of named ``RemoteBackend``s in place of a bare transport
(a bare ``RemoteTransport`` is auto-wrapped as a single-backend registry,
preserving the single-transport behaviour bit for bit). Each escalation window is
routed to one backend picked at submit time — an open breaker fails over
within the same window — and billing/latency attribute per backend in
``CascadeStats.per_backend`` using the backend's own price and modelled
latency (falling back to the ``CostModel`` constants).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Iterator

import numpy as np
import torch

from repro_torch.core.cascade import (combine_escalated, escalation_capacity,
                                      gather_requests, select_escalations)
from repro_torch.core.supervisors import SOFTMAX_SUPERVISORS
from repro_torch.device import resolve_device
from repro_torch.kernels.confidence_gate.ops import confidence_gate
from repro_torch.kernels.fused_head_gate.ops import (FusedLocalHead,
                                                     fused_head_gate)
from repro_torch.kernels.gate_fetch import Emitter, start_fetch
from repro_torch.models.shard_hints import gather
from repro_torch.runtime.observability import (EV_BACKEND_AGREEMENT,
                                               EV_DEADLINE_DOWNGRADE,
                                               EV_POLICY_DOWNGRADE,
                                               EV_STAGE_ANSWER)
from repro_torch.runtime.transport import (RemoteBackend, RemoteRouter,
                                           RouteConstraint)
from repro_torch.serving.policy import (CACHED, DEADLINE_LOCAL, LOCAL,
                                        POLICY_LOCAL, REJECTED, REMOTE,
                                        RequestPolicy, ServeConfig)

def to_device(tree: Any, device: torch.device) -> Any:
    """A (nested dict of) numpy arrays / tensors as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


def _host_rows(tree: Any, rows) -> Any:
    """Gather ``rows`` of every leaf of a host batch (numpy)."""
    if isinstance(tree, dict):
        return {k: _host_rows(v, rows) for k, v in tree.items()}
    return np.asarray(tree)[rows]


def _score_host(supervisor, stacked: list) -> tuple[np.ndarray, np.ndarray]:
    """Supervisor confidence and argmax of host logits rows, computed on
    CPU tensors (remote answers never go back to the device)."""
    rlogits = torch.from_numpy(np.stack(stacked))
    return (supervisor(rlogits).numpy(),
            rlogits.argmax(-1).numpy())


def _any_policy(policies) -> bool:
    """True iff some entry actually constrains serving."""
    return policies is not None and any(
        p is not None and not p.is_default for p in policies)

# per-backend accounting key for escalations no backend would accept
# (every breaker open): they fail without touching any transport
UNROUTED = "(unrouted)"
# the CascadeStats fields that constitute the billing contract: every
# "pipelined/streaming accounting is identical to serial/FIFO" check
# (benchmarks, tests) compares exactly these — extend HERE when stats
# grow a new billable field so the equivalence checks can't silently
# weaken
BILLING_FIELDS = ("requests", "escalations", "remote_calls", "cache_hits",
                  "transport_failures", "rejected", "total_cost")
# attribution for cache entries stored without a source backend
UNATTRIBUTED = "(cache)"
# EMA weight for the per-backend agreement-with-local signal
# (DESIGN.md §13): one observation per committed window per backend
AGREEMENT_ALPHA = 0.2


@dataclass(frozen=True)
class CostModel:
    """Latency/cost constants (paper Table 7 / GPT-3 style billing).

    Cache hits are re-served, not re-billed: they cost ``cache_hit_
    latency_s`` and $0 (DESIGN.md §4). With a multi-remote registry the
    remote constants are *defaults*: a ``RemoteBackend`` carrying its own
    ``cost_per_request`` / ``latency_s`` overrides them per window
    (DESIGN.md §6)."""
    local_latency_s: float = 0.05
    remote_latency_s: float = 0.32       # incl. network round trip
    remote_cost_per_request: float = 0.0048
    cache_hit_latency_s: float = 0.001

    def backend_cost(self, backend) -> float:
        """Per-call price for a backend (None backend/price -> default)."""
        if backend is not None and backend.cost_per_request is not None:
            return backend.cost_per_request
        return self.remote_cost_per_request

    def backend_latency(self, backend) -> float:
        """Modelled round trip for a backend (None -> default)."""
        if backend is not None and backend.latency_s is not None:
            return backend.latency_s
        return self.remote_latency_s


@dataclass
class BackendUsage:
    """Per-backend slice of the cascade accounting (DESIGN.md §6). The
    invariant ``escalations = remote_calls + cache_hits +
    transport_failures`` holds summed over all per-backend entries
    (including the ``UNROUTED`` pseudo-backend)."""
    remote_calls: int = 0            # billed invocations of this backend
    cache_hits: int = 0              # hits on entries this backend filled
    transport_failures: int = 0      # escalations this backend lost
    cost: float = 0.0                # realised $ billed to this backend
    remote_latency_s: float = 0.0    # modelled remote seconds accrued
    # running agreement-with-local EMA over the escalated rows this
    # backend served (DESIGN.md §13): the label-free accuracy signal the
    # 2nd-level threshold can consult — None until the first served row
    agreement_ema: float | None = None
    agreement_rows: int = 0


@dataclass
class CascadeStats:
    requests: int = 0                # genuine (non-padding) requests
    escalations: int = 0             # requests routed past the local tier
    remote_calls: int = 0            # billed remote invocations
    cache_hits: int = 0              # escalations served from cache ($0)
    transport_failures: int = 0      # escalations lost to transport faults
    rejected: int = 0
    total_cost: float = 0.0
    total_latency_s: float = 0.0     # modelled (CostModel constants)
    wall_latency_s: float = 0.0      # measured request-seconds (timers)
    # per-backend billing/latency attribution (runtime path; DESIGN.md §6)
    per_backend: dict = field(default_factory=dict)
    # ring buffer of recent per-window wall times: percentiles stay
    # representative of CURRENT behaviour on long-running servers
    wall_samples: deque = field(
        default_factory=lambda: deque(maxlen=65536), repr=False)
    # EMA of per-window wall service time — the admission controller's
    # queue-wait estimator (DESIGN.md §10): expected_wait ≈ windows_ahead
    # * window_service_ema_s. None until the first window commits.
    window_service_ema_s: float | None = None

    SERVICE_EMA_ALPHA: ClassVar[float] = 0.2

    def backend_usage(self, name: str) -> BackendUsage:
        return self.per_backend.setdefault(name, BackendUsage())

    @property
    def remote_fraction(self) -> float:
        return self.remote_calls / max(self.requests, 1)

    @property
    def escalation_fraction(self) -> float:
        return self.escalations / max(self.requests, 1)

    @property
    def mean_latency_s(self) -> float | None:
        """Modelled mean per-request latency; None before any request —
        empty stats must render as absent, not as a flattering 0.0
        (DESIGN.md §9 empty-stats contract)."""
        if self.requests == 0:
            return None
        return self.total_latency_s / self.requests

    # -- measured wall-clock latency (vs the modelled numbers above) ----
    def record_wall(self, window_wall_s: float, real: int) -> None:
        """Fold one served window's measured wall time into the stats.
        In pipelined mode this spans submit -> drain, so per-request wall
        latency includes pipeline residency, not just compute."""
        self.wall_latency_s += window_wall_s * real
        self.wall_samples.append(float(window_wall_s))
        a = self.SERVICE_EMA_ALPHA
        self.window_service_ema_s = (
            window_wall_s if self.window_service_ema_s is None
            else a * window_wall_s + (1 - a) * self.window_service_ema_s)

    @property
    def mean_wall_latency_s(self) -> float | None:
        """Measured mean per-request wall latency; None before any
        request (empty-stats contract, see ``mean_latency_s``)."""
        if self.requests == 0:
            return None
        return self.wall_latency_s / self.requests

    def wall_percentile(self, q: float) -> float | None:
        """q-th percentile (0-100) of recent per-window wall latency;
        None before any window has been timed."""
        if not self.wall_samples:
            return None
        return float(np.percentile(np.fromiter(self.wall_samples,
                                               np.float64), q))


def make_cascade_step(local_apply: Callable, remote_apply: Callable,
                      capacity: int, supervisor: str = "max_softmax"):
    """Build the fused cascade step (one callable over device tensors).

    local_apply(local_batch) -> logits [B, C]
    remote_apply(remote_batch_gathered) -> logits [k, C]
    Requests carry BOTH input views (paper §4.1 input-domain reduction):
    batch = {"local": <reduced inputs>, "remote": <full inputs>}.

    `supervisor` is a SOFTMAX_SUPERVISORS name, or any callable
    logits -> confidence (e.g. a bound MDSA on hidden states — the paper's
    recommendation for non-softmax local models, §4.2).

    Returns step(batch) -> dict(pred, local_conf, remote_conf, escalated).
    """
    sup = (supervisor if callable(supervisor)
           else SOFTMAX_SUPERVISORS[supervisor])

    def step(batch):
        local_logits = local_apply(batch["local"])
        local_conf = sup(local_logits)
        local_pred = local_logits.argmax(-1)

        idx, esc_mask = select_escalations(local_conf, capacity)
        remote_in = gather_requests(batch["remote"], idx)
        remote_logits = remote_apply(remote_in)
        remote_pred = remote_logits.argmax(-1)
        remote_conf_sub = sup(remote_logits)

        pred = combine_escalated(local_pred, idx, remote_pred)
        # non-escalated requests never consult the 2nd supervisor; fill +inf
        remote_conf = torch.full_like(local_conf, float("inf"))
        remote_conf[idx] = remote_conf_sub.to(remote_conf.dtype)
        return {"prediction": pred, "local_conf": local_conf,
                "remote_conf": remote_conf, "escalated": esc_mask,
                "local_pred": local_pred}

    return step


def make_local_step(local_apply: Callable, supervisor="max_softmax"):
    """Local-tier-only step (legacy runtime path; returns the
    full logits — prefer make_gated_local_step on the hot path)."""
    sup = (supervisor if callable(supervisor)
           else SOFTMAX_SUPERVISORS[supervisor])

    def step(local_batch):
        logits = local_apply(local_batch)
        return {"local_conf": sup(logits),
                "local_pred": logits.argmax(-1),
                "local_logits": logits}

    return step


def make_gated_local_step(local_apply: Callable, supervisor="max_softmax",
                          emit=None):
    """Local tier fused with the confidence gate: supervisor scoring +
    thresholded ascending escalation ranking happen on the device, and
    only the compact ``(conf [B], pred [B], idx [B])`` triple crosses the
    host boundary — never the ``[B, C]`` logits (DESIGN.md §5).

    step(local_batch, t_local [f32 0-d tensor, +inf = no threshold],
         n_valid [i32 0-d tensor]) -> {conf, pred, idx}; the scalars live
    on the device, so retuning changes no launch configuration.

    When ``local_apply`` is a ``FusedLocalHead`` the final projection is
    folded into the gate's scoring pass (kernels/fused_head_gate) so
    full-vocab logits never round-trip through device memory.

    ``emit`` opts into early emit (DESIGN.md §11): the step gains a
    trailing ``seq`` argument and the gate hands its triple to
    ``emit(seq, conf, pred, idx)`` on the host once it lands (a
    ``gate_fetch.Emitter`` on CUDA tensors; see ``confidence_gate.ops``);
    the output then also holds ``fetch``, the copy that ``emit`` waits on.
    """
    fused = isinstance(local_apply, FusedLocalHead)

    @torch.no_grad()
    def gated(local_batch, t_local, n_valid, **emit_kw):
        if fused:
            h = gather(local_apply.trunk(local_batch))
            return fused_head_gate(h, local_apply.w, local_apply.bias,
                                   t_local, n_valid, supervisor=supervisor,
                                   **emit_kw)
        logits = gather(local_apply(local_batch))
        return confidence_gate(logits, t_local, n_valid,
                               supervisor=supervisor, **emit_kw)

    if emit is None:
        return gated

    def step(local_batch, t_local, n_valid, seq):
        return gated(local_batch, t_local, n_valid, emit=emit, emit_tag=seq)

    return step


def _leading_rows(tree: Any) -> int:
    if isinstance(tree, dict):
        return _leading_rows(next(iter(tree.values())))
    return int(tree.shape[0]) if hasattr(tree, "shape") else \
        int(np.asarray(tree).shape[0])


class _Resolved:
    """Adapter giving a synchronous transport result the future API."""

    def __init__(self, result):
        self._result = result

    def done(self) -> bool:
        return True

    def result(self, timeout=None):
        return self._result


@dataclass
class _InFlight:
    """One microbatch's per-request completion bookkeeping, from dispatch
    to its accounting commit. Lifecycle (DESIGN.md §7)::

        dispatch      device local forward launched; control state
                      (capacity, t_local) snapshotted at submit time
        host half     gate triple fetched, cache lookups, routing,
                      remote submission  (deferred one begin by the
                      double buffer; ``host_done`` flips here)
        finalize      remote responses folded in, acceptance decided
                      with the CURRENT t_remote (``finalized`` flips;
                      ``result`` holds the per-request outputs)
        commit        stats / per-backend billing / controller observe
                      — strictly in submission (seq) order
    """
    seq: int                    # submission order (1-based, monotonic)
    t0: float
    b: int                      # padded batch rows
    real: int                   # genuine leading rows
    asynchronous: bool          # futures (pipelined) vs sync transport
    capacity: int               # escalation cap snapshotted at dispatch
    # -- per-request policy layer (DESIGN.md §8) -------------------------
    policies: Any = None        # [real] RequestPolicy | None per row
    t_enq: Any = None           # [real] enqueue stamps (deadline anchor)
    policed: bool = False       # any row carries a non-trivial policy
    downgraded: dict = field(default_factory=dict)  # row -> disposition
    forced: set = field(default_factory=set)   # idx POSITIONS policy-REJECTED
    blocked: int = 0            # rows policy withheld from escalation
    constraint: Any = None      # merged RouteConstraint (cap/hint part)
    # earliest absolute deadline among escalating rows (engine clock);
    # the latency ceiling is recomputed from it at every routing
    # decision — submit-time pick AND drain-time replay — so a window
    # that rode the pipeline can't be served against a stale budget
    abs_deadline: float | None = None
    early: list = field(default_factory=list)  # rows decidable at host half
    # -- dispatch half (device) ----------------------------------------
    gate_fetch: Any = None      # the gate triple's PendingTriple
    remote_batch: Any = None    # batch["remote"], held until the host half
    gate_done: bool = False     # gate half ran (conf/pred/idx pinned)
    host_done: bool = False
    # -- host half ------------------------------------------------------
    conf: np.ndarray | None = None   # [b] 1st-level confidences
    local_pred: np.ndarray | None = None  # [b] local preds (never mutated)
    pred: np.ndarray | None = None   # [b] served preds (remote scattered)
    idx: np.ndarray | None = None    # [k] escalated row indices (asc conf)
    k: int = 0
    keys: list | None = None    # cache keys per escalated row
    cached: list | None = None  # cache hits / filled-in remote responses
    hit_src: list | None = None # backend name per cache hit (attribution)
    miss: list = field(default_factory=list)  # idx positions gone remote
    pending: Any = None         # TransportFuture | _Resolved | None
    backend: Any = None         # RemoteBackend routed to (None = unrouted)
    replay_ticket: bool = False # parked for a bounded (unrouted) replay
    sub_miss: Any = None        # miss sub-batch, held only for a replay
    # -- finalize half --------------------------------------------------
    finalized: bool = False
    result: dict | None = None
    remote_conf: np.ndarray | None = None
    n_sent: int = 0
    n_failed: int = 0
    n_hits: int = 0
    bname: str = UNROUTED
    # per-row stage attribution from a chained CascadeStage backend
    # (DESIGN.md §13); None for plain backends and terminal stages, which
    # keeps the degenerate 2-stage config on the existing path
    stage_detail: dict | None = None
    stage_split: dict | None = None  # stage -> [calls, failures, cost, lat]
    agreement: list | None = None    # (backend, rows, window frac, ema)
    # -- observability (DESIGN.md §9) -----------------------------------
    # per-window stage timestamps (dispatch/gate/route/remote/commit) +
    # the gating threshold; None when observability is disabled, so the
    # hot path allocates nothing per window, let alone per row
    tr: dict | None = None


class CascadeEngine:
    """Host-side engine: batching, runtime thresholds, accounting.

    Legacy fused construction (remote tier = bare infallible callable,
    static capacity)::

        CascadeEngine(local_apply, remote_apply, batch_size=32,
                      remote_fraction_budget=0.25, t_remote=0.9)

    Runtime construction (fault-aware transport, optional controller and
    response cache — DESIGN.md §2)::

        CascadeEngine(local_apply, batch_size=32,
                      remote_fraction_budget=0.25, t_remote=0.9,
                      transport=RemoteTransport(remote_apply),
                      controller=AdaptiveController(),
                      cache=RemoteResponseCache())

    Multi-remote construction (DESIGN.md §6) — pass a router instead::

        CascadeEngine(local_apply, batch_size=32, ...,
                      transport=RemoteRouter([
                          RemoteBackend("cheap", apply_a,
                                        cost_per_request=0.002),
                          RemoteBackend("fast", apply_b,
                                        cost_per_request=0.008),
                      ], policy="cheapest-available"))

    A bare transport is wrapped as a single-backend registry; predictions
    and billing stay bitwise-identical to the pre-registry path.

    The runtime path can serve synchronously (``serve``), pipelined
    (``begin_serve`` / ``complete_next`` — DESIGN.md §5, completions
    drain strictly in submission order), or streaming (``begin_serve`` /
    ``complete_ready`` / ``stream`` — DESIGN.md §7, windows hand back the
    moment their remote futures resolve while accounting still commits in
    submission order). In all three, results, stats and controller state
    do not depend on remote completion order. ``close()`` (or using the
    engine as a context manager) drains in-flight windows and shuts down
    every backend's thread pool.
    """

    def __init__(self, local_apply, remote_apply=None, *, batch_size: int,
                 remote_fraction_budget: float,
                 t_remote: float, cost: CostModel = CostModel(),
                 supervisor="max_softmax", transport=None, controller=None,
                 cache=None, clock: Callable[[], float] = time.perf_counter,
                 default_policy: RequestPolicy | None = None,
                 observability=None, early_emit: bool | str = False,
                 mesh=None, device: str | torch.device = "cuda"):
        if remote_apply is None and transport is None:
            raise ValueError("need a remote tier: remote_apply or transport")
        self.batch_size = batch_size
        self.capacity = escalation_capacity(batch_size,
                                            remote_fraction_budget)
        self.t_remote = t_remote            # runtime-tunable (paper §4.5)
        self.t_local: float | None = None   # runtime-tunable escalation gate
        self.cost = cost
        self.stats = CascadeStats()
        # `transport` may be a RemoteTransport OR a RemoteRouter; keep the
        # raw object (schedulers/tests check `engine.transport`) and route
        # internally through a registry either way
        self.transport = transport
        self.router: RemoteRouter | None = None
        if transport is not None:
            self.router = (transport if isinstance(transport, RemoteRouter)
                           else RemoteRouter(
                               [RemoteBackend("remote", transport=transport)]))
        self.controller = controller
        self.cache = cache
        # default RequestPolicy applied to rows without their own; a
        # trivial default collapses to None so unpolicied traffic keeps
        # the zero-overhead fast path (DESIGN.md §8)
        self.default_policy = (default_policy
                               if default_policy is not None
                               and not default_policy.is_default else None)
        self._clock = clock
        # opt-in for _early_decide (DESIGN.md §8): only a streaming
        # consumer reads fl.early, so the streaming scheduler flips this
        # and the FIFO paths skip the extra host-half supervisor pass
        self.early_handback = False
        self._inflight: deque[_InFlight] = deque()
        self._seq = 0
        # set by any window's remote future resolving (any backend): the
        # streaming drain parks here instead of polling head-of-line
        self._ready = threading.Event()
        self._supervisor = (supervisor if callable(supervisor)
                            else SOFTMAX_SUPERVISORS[supervisor])
        # observability facade (DESIGN.md §9): None = disabled; install()
        # wires the router/transports/controller into the shared event
        # log and registers the snapshot-time metrics collector
        self.observability = None
        if observability is not None:
            observability.install(self)
        self.mesh = mesh
        self.device = resolve_device(device)
        # early emit (DESIGN.md §11): an Emitter thread lands each
        # window's gate triple in _gate_results as its copy completes.
        # "auto" arms it where dispatch is asynchronous (CUDA, as JAX arms
        # it on a TPU); on the CPU the triple is on the host as soon as
        # the step returns. It never changes what is served: unarmed or
        # late, the host half waits on the copy's event itself.
        if early_emit == "auto":
            early_emit = self.device.type == "cuda"
        self.early_emit = bool(early_emit) and transport is not None
        self._gate_emits = 0            # telemetry: triples emitted
        self._gate_lock = threading.Lock()
        self._gate_results: dict[int, tuple] = {}
        self._committed_seq = 0         # emits at or below it are stale
        self._emitter = Emitter(self._on_gate) if self.early_emit else None
        if transport is None:
            self._step = make_cascade_step(
                local_apply, remote_apply, self.capacity, supervisor)
        else:
            step = make_gated_local_step(local_apply, supervisor,
                                         emit=self._emitter)
            # data-parallel local forward (DESIGN.md §12): the step lays
            # its batch out over the mesh's data ranks, parameters
            # replicated, and gathers the rows before the gate
            if mesh is not None:
                from repro_torch.launch.sharding import shard_local_step
                step = shard_local_step(step, mesh)
            self._local_step = step

    # -- ServeConfig construction (DESIGN.md §8) -----------------------
    _UNSET = object()

    @classmethod
    def from_config(cls, config: ServeConfig, local_apply,
                    remote_apply=None, *, transport=None,
                    controller=_UNSET, cache=_UNSET,
                    observability=_UNSET, mesh=_UNSET,
                    clock: Callable[[], float] = time.perf_counter,
                    device: str | torch.device = "cuda"
                    ) -> "CascadeEngine":
        """Build the engine from one ``ServeConfig`` (the supported
        construction path). On the runtime path the remote registry is
        built from ``remote_apply`` per ``config.remotes`` unless a
        ``transport``/router is passed explicitly; the controller,
        response cache, observability facade and data-parallel mesh come
        from the config unless overridden (pass ``controller=None``/
        ``cache=None``/``observability=None``/``mesh=None`` to force
        them off — the cluster harness overrides all four per replica,
        DESIGN.md §12). Early emit is ``"auto"`` under continuous
        batching and off otherwise."""
        if config.fused:
            eng = cls(local_apply, remote_apply,
                      batch_size=config.batch_size,
                      remote_fraction_budget=config.remote_fraction_budget,
                      t_remote=config.t_remote,
                      cost=config.cost or CostModel(),
                      supervisor=config.supervisor, clock=clock,
                      device=device)
        else:
            if transport is None:
                if remote_apply is None:
                    raise ValueError("runtime path needs remote_apply or "
                                     "an explicit transport/router")
                transport = config.build_router(remote_apply)
            if mesh is cls._UNSET:
                if config.data_parallel:
                    from repro_torch.launch.mesh import make_serving_mesh
                    mesh = make_serving_mesh(device)
                else:
                    mesh = None
            eng = cls(local_apply, batch_size=config.batch_size,
                      remote_fraction_budget=config.remote_fraction_budget,
                      t_remote=config.t_remote,
                      cost=config.cost or CostModel(),
                      supervisor=config.supervisor, transport=transport,
                      controller=(config.build_controller()
                                  if controller is cls._UNSET
                                  else controller),
                      cache=(config.build_cache() if cache is cls._UNSET
                             else cache),
                      clock=clock, default_policy=config.default_policy,
                      observability=(config.build_observability()
                                     if observability is cls._UNSET
                                     else observability),
                      early_emit=("auto"
                                  if config.batching == "continuous"
                                  else False),
                      mesh=mesh, device=device)
        if config.t_local is not None:
            eng.set_local_threshold(config.t_local)
        return eng

    # -- early emit (DESIGN.md §11) --------------------------------------
    def _on_gate(self, seq, conf, pred, idx) -> None:
        """Emitter target: window ``seq``'s gate triple just landed on the
        host. Runs on the emitter thread, so it only stores and signals;
        consumers poll ``gate_result``. A triple of a window already
        committed is counted and dropped (the host half waited on the
        event first, and the commit has swept)."""
        with self._gate_lock:
            if int(seq) > self._committed_seq:
                self._gate_results[int(seq)] = (np.array(conf),
                                                np.array(pred),
                                                np.array(idx))
            self._gate_emits += 1
        self._ready.set()

    def gate_result(self, seq: int):
        """The early-emitted gate triple for window ``seq`` (``(conf,
        pred, idx)`` numpy arrays), or None if it has not landed yet.
        Entries are consumed by the window's host half and swept at
        commit; callers must treat the arrays as read-only."""
        with self._gate_lock:
            return self._gate_results.get(seq)

    def set_remote_threshold(self, t: float) -> None:
        """Runtime reconfiguration (paper §4.5)."""
        self.t_remote = t

    def set_local_threshold(self, t: float | None) -> None:
        """Runtime escalation gate (runtime path; None = capacity-k)."""
        self.t_local = t

    # ------------------------------------------------------------------
    def serve(self, batch: dict[str, Any], real_rows: int | None = None,
              policies=None, t_enq=None) -> dict[str, np.ndarray]:
        """Serve one batch; ``real_rows`` marks how many leading rows are
        genuine — padded replicas beyond it are served (static jit shapes)
        but never counted or billed. ``policies`` carries one
        ``RequestPolicy | None`` per genuine row and ``t_enq`` the rows'
        enqueue stamps (the deadline anchor) — DESIGN.md §8."""
        if self.transport is None:
            if _any_policy(policies) or self.default_policy is not None:
                raise RuntimeError("per-request policies need the runtime "
                                   "path (construct the engine with "
                                   "transport=...)")
            return self._serve_fused(batch, real_rows)
        if self._inflight:
            raise RuntimeError("pipelined windows in flight; drain them "
                               "with complete_next() before serve()")
        fl = self._dispatch(batch, real_rows, asynchronous=False,
                            policies=policies, t_enq=t_enq)
        self._host_begin(fl)
        self._finalize(fl)
        return self._commit(fl)

    # -- pipelined runtime path (DESIGN.md §5, §7) ---------------------
    def begin_serve(self, batch: dict[str, Any],
                    real_rows: int | None = None,
                    policies=None, t_enq=None) -> _InFlight:
        """Dispatch one microbatch's local forward on the device, then
        run the host half of the PREVIOUS window (double buffering,
        DESIGN.md §7): the gate triple fetch, cache lookups, routing and
        the non-blocking remote submission of batch i happen while batch
        i+1 computes on the accelerator. Returns the window handle; its
        ``conf``/``local_pred``/``idx`` fields populate once its own host
        half runs (at the next begin, ``flush_dispatch``, or its drain)."""
        if self.transport is None:
            raise RuntimeError("pipelined serving needs the runtime path "
                               "(construct the engine with transport=...)")
        prev = self._inflight[-1] if self._inflight else None
        fl = self._dispatch(batch, real_rows, asynchronous=True,
                            policies=policies, t_enq=t_enq)
        self._inflight.append(fl)
        if prev is not None and not prev.host_done:
            self._host_begin(prev)
        return fl

    def flush_gate(self) -> None:
        """Run only the GATE half of the NEWEST window's deferred host
        work: triple fetch + escalation-set pinning + policy pass, no
        cache/routing/transport. The continuous scheduler calls this
        right after ``begin_serve`` so trusted-local rows hand back
        before the escalations are even routed; ``flush_dispatch`` (or
        the drain) later completes the submit half (DESIGN.md §11)."""
        if self._inflight and not self._inflight[-1].gate_done:
            self._host_gate(self._inflight[-1])

    def flush_dispatch(self) -> None:
        """Run the deferred host half of the NEWEST window (the double
        buffer parks it until the next begin). Call when no further
        ``begin_serve`` is coming, so the last window's remote submission
        overlaps the earlier drains instead of serialising behind them."""
        if self._inflight and not self._inflight[-1].host_done:
            self._host_begin(self._inflight[-1])

    def complete_next(self) -> dict[str, np.ndarray] | None:
        """Drain the OLDEST in-flight window (blocks until its remote
        responses land). FIFO draining keeps accounting and controller
        observations independent of remote completion order."""
        if not self._inflight:
            return None
        fl = self._inflight[0]
        self._finalize(fl)              # forces a parked host half too
        self._inflight.popleft()
        return self._commit(fl)

    # -- streaming completion (DESIGN.md §7) ---------------------------
    def complete_ready(self, block: bool = False
                       ) -> list[tuple[int, dict[str, np.ndarray]]]:
        """Per-request streaming drain: finalize every in-flight window
        whose remote responses have landed and hand back their results —
        OUT of submission order — while accounting (stats, per-backend
        billing, controller observations) still commits strictly in
        submission order, so totals are bitwise-identical to the FIFO
        drain.

        With a live controller the ready set is restricted to the FIFO
        prefix: acceptance thresholds evolve with every committed window,
        so finalizing out of order would change which remote answers are
        trusted. Static thresholds have no such coupling and windows
        finalize the moment their future resolves. Windows parked with an
        (unrouted) replay ticket wait until they reach the head, giving a
        breaker the full pipeline residency to half-open before the
        replay pick.

        With a response cache, out-of-order finalize makes cache FILL
        timing depend on remote latency, so the cache_hits/remote_calls
        split (and hence total_cost) may differ from the FIFO drain when
        escalated content repeats across in-flight windows — bounded and
        benign: hits can only be gained, cost can only drop, and served
        predictions are unchanged (an entry holds the very logits the
        remote call would return). The bitwise-billing guarantee is
        exact for cacheless runs and for repeats across already-drained
        windows (DESIGN.md §7).

        Returns ``(seq, result)`` pairs for windows finalized by THIS
        call, ``seq`` being the value on the ``begin_serve`` handle. With
        ``block=True`` waits until at least one window finalizes
        (returns ``[]`` immediately when nothing is in flight)."""
        while True:
            events = self._scan_ready()
            if events or not block or not self._inflight:
                return events
            self._ready.clear()
            events = self._scan_ready()  # racing resolve before clear()
            if events:
                return events
            # event wakeup from any backend's pool; the timeout is a
            # safety net, not a poll interval
            self._ready.wait(0.05)

    def stream(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        """Generator draining every in-flight window in completion order
        (``complete_ready`` semantics): yields ``(seq, result)`` as each
        window's remote responses land."""
        while self._inflight:
            yield from self.complete_ready(block=True)

    def _scan_ready(self) -> list[tuple[int, dict[str, np.ndarray]]]:
        """One non-blocking pass of the streaming drain: finalize every
        ready window, then commit the contiguous finalized prefix.

        With a controller, finalize NEVER runs ahead of commit: window
        i+1's acceptance must see the t_remote that window i's
        observation produced, so the pass walks head-first, committing
        each window before looking at the next."""
        events: list[tuple[int, dict[str, np.ndarray]]] = []
        if self.controller is not None:        # FIFO prefix only
            while self._inflight:
                fl = self._inflight[0]
                if not fl.host_done:
                    # only the newest window can be parked; head+parked
                    # means it is alone — nothing else can unblock it
                    self._host_begin(fl)
                if fl.pending is not None and not fl.pending.done():
                    break
                self._finalize(fl)
                events.append((fl.seq, fl.result))
                self._commit(self._inflight.popleft())
            return events
        progressed = True
        while progressed and self._inflight:
            progressed = False
            # a lone parked window cannot be unblocked by anything else:
            # run its host half so its remote round trip starts
            if len(self._inflight) == 1 and not self._inflight[0].host_done:
                self._host_begin(self._inflight[0])
                progressed = True
            head = self._inflight[0]
            for fl in self._inflight:
                if fl.finalized or not fl.host_done:
                    continue
                if fl.pending is not None:
                    ready = fl.pending.done()
                else:
                    # no remote in flight: ready now — except a replay
                    # ticket, which waits for the head (max residency
                    # for a breaker to half-open before the replay pick)
                    ready = not fl.replay_ticket or fl is head
                if ready:
                    self._finalize(fl)
                    events.append((fl.seq, fl.result))
                    progressed = True
            while self._inflight and self._inflight[0].finalized:
                self._commit(self._inflight.popleft())
                progressed = True
        return events

    @property
    def inflight(self) -> int:
        """Windows begun but not yet COMMITTED (the backpressure bound)."""
        return len(self._inflight)

    # -- fused path (seed semantics + padding-aware accounting) --------
    def _serve_fused(self, batch, real_rows):
        t0 = self._clock()
        out = {k: v.cpu().numpy()
               for k, v in self._step(to_device(batch, self.device)).items()}
        b = out["prediction"].shape[0]
        real = b if real_rows is None else min(real_rows, b)
        escalated = out["escalated"]
        accepted = (~escalated) | (out["remote_conf"] > self.t_remote)
        n_remote = int(escalated[:real].sum())
        self._account(real, n_remote, n_remote, 0, 0,
                      int((~accepted[:real]).sum()))
        self.stats.record_wall(self._clock() - t0, real)
        if self.controller is not None:
            self.controller.observe(
                out["local_conf"][:real], n_remote, real,
                out["remote_conf"][:real],
                cost=n_remote * self.cost.remote_cost_per_request)
        out["accepted"] = accepted
        return out

    # -- runtime path: dispatch half (device) --------------------------
    def _dispatch(self, batch, real_rows, *, asynchronous: bool,
                  policies=None, t_enq=None) -> _InFlight:
        """Launch the local forward + confidence gate on the device and
        snapshot the submit-time control state. Returns WITHOUT fetching
        the gate output — the host half (``_host_begin``) runs one begin
        later, so the device computes the next batch meanwhile."""
        t0 = self._clock()
        b = _leading_rows(batch["local"])
        real = b if real_rows is None else min(real_rows, b)

        # --- escalation set: controller threshold, capped by capacity ---
        capacity = (self.controller.capacity(self.batch_size)
                    if self.controller is not None else self.capacity)
        # calibrated warm start: engine t_local applies until the
        # controller has produced its own (mirrors t_remote at complete)
        t_local = self.t_local
        if self.controller is not None and self.controller.t_local is not None:
            t_local = self.controller.t_local
        # 0-d device scalars: a new threshold is data, not a new launch.
        # The triple's copy is queued right behind the gate, ahead of
        # anything a transport thread queues later. With early emit the
        # gate starts the copy and hands it to the emitter; the host half
        # waits on that same copy
        dev = self.device
        self._seq += 1
        t = torch.tensor(np.inf if t_local is None else t_local,
                         dtype=torch.float32, device=dev)
        n = torch.tensor(real, dtype=torch.int32, device=dev)
        x = to_device(batch["local"], dev)
        if self.early_emit:
            fetch = self._local_step(x, t, n, self._seq)["fetch"]
        else:
            fetch = start_fetch(self._local_step(x, t, n))
        fl = _InFlight(seq=self._seq, t0=t0, b=b, real=real,
                       asynchronous=asynchronous, capacity=capacity,
                       gate_fetch=fetch, remote_batch=batch["remote"],
                       policies=policies, t_enq=t_enq,
                       policed=(_any_policy(policies)
                                or self.default_policy is not None))
        if self.observability is not None:
            # per-window stage timeline (DESIGN.md §9): one dict per
            # WINDOW, so disabled mode allocates nothing
            fl.tr = {"dispatch": t0,
                     "t_local": None if t_local is None else float(t_local)}
        return fl

    # -- runtime path: host half ---------------------------------------
    def _host_gate(self, fl: _InFlight) -> None:
        """The CHEAP half of the host work: land the gate triple on the
        host (early-emit reuse or the fetch's wait), pin the escalation set
        and run the per-request policy pass. After this every locally-
        trusted row is fully decidable — the continuous scheduler calls
        it via ``flush_gate`` so those rows hand back BEFORE the
        escalations' cache/routing/transport submission (DESIGN.md
        §11)."""
        emitted = self.gate_result(fl.seq) if self.early_emit else None
        # the emitter already landed this window's triple, or the copy
        # queued at dispatch is waited on here (its event, never a read of
        # the pinned buffers before it)
        conf, pred, cand = (emitted if emitted is not None
                            else fl.gate_fetch.wait())
        fl.gate_fetch = None
        fl.conf = np.asarray(conf)
        fl.local_pred = np.asarray(pred)
        fl.pred = fl.local_pred.copy()
        cand = np.asarray(cand)
        cand = cand[cand >= 0]          # eligible rows, ascending by conf
        fl.k = int(min(cand.size, fl.capacity, fl.real))
        fl.idx = cand[:fl.k]
        if fl.tr is not None:
            fl.tr["gate"] = self._clock()

        if fl.policed:
            # per-request policy pass (DESIGN.md §8): escalation
            # overrides, cost-cap and deadline-vs-EMA feasibility — may
            # shrink/extend fl.idx and record downgrades/forced rejects
            self._apply_policies(fl)
        fl.gate_done = True

    def _host_begin(self, fl: _InFlight) -> None:
        """Run the host escalation path: the gate half (if it hasn't run
        yet), then batched gather, cache lookups, submit-time routing and
        the remote submission for the misses."""
        if not fl.gate_done:
            self._host_gate(fl)
        if fl.k > 0:
            sub = _host_rows(fl.remote_batch, fl.idx)     # batched gather
            if self.cache is not None:
                fl.keys = self.cache.keys_for(sub, fl.k)
                # policy-REJECTED rows never consult cache or transport
                found = [None if j in fl.forced else self.cache.lookup(key)
                         for j, key in enumerate(fl.keys)]
                fl.cached = [f[0] if f is not None else None for f in found]
                fl.hit_src = [f[1] if f is not None else None for f in found]
            else:
                fl.keys = [None] * fl.k
                fl.cached = [None] * fl.k
                fl.hit_src = [None] * fl.k
            fl.miss = [j for j, c in enumerate(fl.cached)
                       if c is None and j not in fl.forced]
            if fl.miss:
                # route the window at submit time; an open breaker fails
                # over to the next policy candidate immediately. The
                # merged RouteConstraint (cost cap / remaining deadline /
                # hint) narrows the candidate set (DESIGN.md §8)
                fl.backend = self.router.pick(self._window_constraint(fl),
                                              window=fl.seq)
                marr = np.asarray(fl.miss)
                sub_miss = _host_rows(sub, marr)
                if fl.backend is not None:
                    fl.pending = (fl.backend.submit(sub_miss, fl.seq)
                                  if fl.asynchronous
                                  else _Resolved(
                                      fl.backend.call(sub_miss, fl.seq)))
                    if fl.asynchronous:
                        # ready-set wakeup for the streaming drain
                        fl.pending.add_done_callback(
                            lambda _f: self._ready.set())
                elif (fl.asynchronous
                      and self.router.acquire_replay_slot(window=fl.seq)):
                    # every breaker refused: park the window with a
                    # bounded replay ticket — redeemed at its drain, when
                    # a breaker may have half-opened (DESIGN.md §7). The
                    # sync path finalizes immediately, so a ticket there
                    # could never be served — don't burn a slot on it
                    fl.replay_ticket = True
                    fl.sub_miss = sub_miss
            if (fl.asynchronous and self.early_handback
                    and self.controller is None):
                # cache hits are fully decidable now (static t_remote):
                # expose them so the streaming scheduler hands them back
                # with the trusted locals instead of after the window's
                # remote drain (DESIGN.md §8; the finalize half still
                # recomputes, keeping FIFO results untouched)
                self._early_decide(fl)
        if fl.tr is not None and fl.k > 0:
            fl.tr["route"] = self._clock()
        fl.remote_batch = None
        fl.host_done = True

    # -- per-request policy layer (DESIGN.md §8) -----------------------
    def _policy_for(self, fl: _InFlight, i: int) -> RequestPolicy | None:
        p = fl.policies[i] if fl.policies is not None else None
        return p if p is not None else self.default_policy

    def _apply_policies(self, fl: _InFlight) -> None:
        """Apply each genuine row's ``RequestPolicy`` to the gate's
        escalation set (host half, before any cache/transport work):

        * ``escalation="never"``    — row leaves the set (POLICY_LOCAL);
        * ``escalation="always"``   — row joins the set even when the
          gate trusted it (explicit per-request demand; bypasses the
          batch capacity cap, feasibility still applies);
        * ``cost_cap`` infeasible (cheapest available backend above the
          cap, or no backend) — POLICY_LOCAL downgrade, or the REJECTED
          path with ``on_miss="reject"``;
        * ``deadline_s`` infeasible — the remaining budget
          ``deadline_s - (now - t_enq)`` is checked against the fastest
          available backend's round-trip estimate (measured EMA,
          modelled prior until observations land): DEADLINE_LOCAL
          downgrade or REJECTED per ``on_miss``.

        Surviving constrained rows merge into one ``RouteConstraint``
        (tightest cap/deadline, first hint) since one window is served
        by exactly one backend."""
        now = self._clock()
        default_cost = self.cost.remote_cost_per_request
        # loop-invariant router scans, hoisted: one availability snapshot
        # per WINDOW (also more consistent than per-row reads racing
        # concurrent breaker flips)
        min_cost = self.router.min_available_cost(default_cost)
        lat_by_cap: dict[float | None, float | None] = {}

        def min_latency(cap):
            if cap not in lat_by_cap:
                lat_by_cap[cap] = self.router.min_latency_estimate(
                    max_cost=cap, default_cost=default_cost)
            return lat_by_cap[cap]

        gate_rows = {int(i) for i in fl.idx}
        drop: set[int] = set()          # downgraded rows (leave the set)
        forced: set[int] = set()        # policy-REJECTED rows (stay)
        adds: list[int] = []            # escalation="always" additions
        caps: list[float] = []
        abs_deadlines: list[float] = []  # anchor + deadline_s (absolute)
        hints: list[str] = []
        for i in range(fl.real):
            p = self._policy_for(fl, i)
            if p is None or p.is_default:
                continue
            in_gate = i in gate_rows
            if p.escalation == "never":
                if in_gate:
                    drop.add(i)
                    fl.downgraded[i] = POLICY_LOCAL
                continue
            if not in_gate and p.escalation != "always":
                continue
            # feasibility: cost cap first, then deadline-vs-EMA
            infeasible = None
            if p.cost_cap is not None:
                if min_cost is None or min_cost > p.cost_cap + 1e-12:
                    infeasible = POLICY_LOCAL
            if infeasible is None and p.deadline_s is not None:
                anchor = (fl.t_enq[i] if fl.t_enq is not None else fl.t0)
                remaining = p.deadline_s - (now - anchor)
                est = min_latency(p.cost_cap)
                if est is None or est > remaining:
                    infeasible = DEADLINE_LOCAL
                else:
                    abs_deadlines.append(anchor + p.deadline_s)
            if infeasible is not None:
                if p.on_miss == "reject":
                    forced.add(i)
                    if not in_gate:
                        adds.append(i)
                else:
                    if in_gate:
                        drop.add(i)
                    fl.downgraded[i] = infeasible
                continue
            if not in_gate:
                adds.append(i)
            if p.cost_cap is not None:
                caps.append(p.cost_cap)
            if p.routing_hint is not None:
                hints.append(p.routing_hint)
        new_idx = [i for i in map(int, fl.idx) if i not in drop]
        # appended demands keep the ascending-confidence convention
        new_idx.extend(sorted(adds, key=lambda i: float(fl.conf[i])))
        fl.idx = np.asarray(new_idx, np.int64)
        fl.k = len(new_idx)
        fl.forced = {j for j, i in enumerate(new_idx) if i in forced}
        fl.blocked = len(drop) + len(forced)
        fl.abs_deadline = min(abs_deadlines) if abs_deadlines else None
        if caps or abs_deadlines or hints:
            fl.constraint = RouteConstraint(
                max_cost=min(caps) if caps else None,
                hint=hints[0] if hints else None,
                default_cost=default_cost)

    def _window_constraint(self, fl: _InFlight) -> RouteConstraint | None:
        """The window's routing constraint AT THIS INSTANT: the latency
        ceiling is the tightest row's remaining deadline budget
        recomputed against the current clock, so a replay pick after
        pipeline residency sees the burnt-down budget (an expired one
        admits no backend and the window keeps the REJECTED path)."""
        if fl.constraint is None:
            return None
        if fl.abs_deadline is None:
            return fl.constraint
        return RouteConstraint(
            max_cost=fl.constraint.max_cost,
            max_latency_s=fl.abs_deadline - self._clock(),
            hint=fl.constraint.hint,
            default_cost=fl.constraint.default_cost)

    def _early_decide(self, fl: _InFlight) -> None:
        """Pre-decide rows that need no remote round trip — cache hits —
        with the CURRENT (static) ``t_remote``, so the streaming
        scheduler hands them back at gate-clear time instead of after
        the window's drain (the satellite latency fix; DESIGN.md §8).
        Only runs without a controller: a live controller couples
        acceptance to commit order."""
        hit = [j for j in range(fl.k)
               if j not in fl.forced and fl.cached[j] is not None]
        if not hit:
            return
        rconf, rpred = _score_host(self._supervisor,
                                   [fl.cached[j] for j in hit])
        for w, j in enumerate(hit):
            i = int(fl.idx[j])
            accepted = bool(rconf[w] > self.t_remote)
            fl.early.append({
                "row": i, "accepted": accepted,
                "prediction": int(rpred[w]),
                "remote_conf": float(rconf[w]),
                "disposition": CACHED if accepted else REJECTED,
                "backend": (fl.hit_src[j] if fl.hit_src[j] is not None
                            else UNATTRIBUTED),
                "cost": 0.0,
            })

    # -- runtime path: finalize half -----------------------------------
    def _finalize(self, fl: _InFlight) -> None:
        """Fold the window's remote responses in and decide acceptance
        with the CURRENT t_remote. Blocks on the window's future (forcing
        a parked host half first). Idempotent; does NOT touch stats — the
        commit half does, strictly in submission order."""
        if fl.finalized:
            return
        if not fl.host_done:
            self._host_begin(fl)
        remote_conf = np.full((fl.b,), np.inf, np.float32)
        n_hits = n_sent = n_failed = 0
        if fl.k > 0:
            cached = fl.cached
            if fl.miss:
                if fl.pending is None and fl.replay_ticket:
                    # (unrouted) replay (DESIGN.md §7): one more pick at
                    # drain time — a breaker that half-opened while the
                    # window rode the pipeline serves it (the call IS the
                    # half-open probe), billed to the replaying backend
                    fl.replay_ticket = False
                    fl.backend = self.router.redeem_replay(
                        self._window_constraint(fl), window=fl.seq)
                    if fl.backend is not None:
                        fl.pending = _Resolved(
                            fl.backend.call(fl.sub_miss, fl.seq))
                    fl.sub_miss = None
                if fl.pending is not None:
                    logits, ok = fl.pending.result()
                    n_sent = int(ok.sum())
                    n_failed = len(fl.miss) - n_sent
                    bname = fl.backend.name
                    # a chained CascadeStage hands back which hop answered
                    # each row, at what confidence and price (DESIGN.md
                    # §13); plain backends and terminal stages return
                    # None, keeping the existing path byte-for-byte
                    take = getattr(fl.backend, "take_detail", None)
                    fl.stage_detail = (take(fl.seq) if take is not None
                                       else None)
                    det = fl.stage_detail
                    for w, j in enumerate(fl.miss):
                        if ok[w]:
                            cached[j] = logits[w]
                            if self.cache is not None:
                                src = (str(det["stage"][w])
                                       if det is not None else bname)
                                self.cache.put(fl.keys[j], logits[w],
                                               source=src)
                else:                 # no backend available at submit time
                    n_failed = len(fl.miss)
            n_hits = fl.k - len(fl.miss) - len(fl.forced)
            got = [j for j, c in enumerate(cached) if c is not None]
            if got:
                rconf, rpred = _score_host(self._supervisor,
                                           [cached[j] for j in got])
                remote_conf[fl.idx[got]] = rconf
                fl.pred[fl.idx[got]] = rpred
            failed = [j for j, c in enumerate(cached) if c is None]
            # transport-lost escalations: 2nd supervisor can never trust
            # them -> REJECTED -> scheduler fallback (Algorithm 1 line 12)
            remote_conf[fl.idx[failed]] = -np.inf
            if fl.stage_detail is not None:
                # fresh rows answered mid-chain carry the answering
                # stage's OWN supervisor score — that is the confidence
                # the accept gate below must judge, not the engine
                # supervisor re-scored on the spliced logits
                sdet = fl.stage_detail
                for w, j in enumerate(fl.miss):
                    if cached[j] is not None:
                        remote_conf[fl.idx[j]] = sdet["conf"][w]

        escalated = np.zeros((fl.b,), bool)
        escalated[fl.idx] = True
        t_remote = self.t_remote
        if self.controller is not None and self.controller.t_remote is not None:
            t_remote = self.controller.t_remote
        accepted = (~escalated) | (remote_conf > t_remote)
        if fl.tr is not None:
            if fl.k > 0:
                fl.tr["remote"] = self._clock()
            fl.tr["t_remote"] = float(t_remote)

        fl.remote_conf = remote_conf
        fl.n_sent, fl.n_failed, fl.n_hits = n_sent, n_failed, n_hits
        fl.bname = fl.backend.name if fl.backend is not None else UNROUTED

        # per-row billing attribution for the API boundary (DESIGN.md §8):
        # how each row was served, by which backend, at what billed $
        disposition = np.full((fl.b,), LOCAL, object)
        row_backend = np.full((fl.b,), None, object)
        row_cost = np.zeros((fl.b,), np.float64)
        for i, d in fl.downgraded.items():
            disposition[i] = d
        cost_per = self.cost.backend_cost(fl.backend)
        miss_set = set(fl.miss)
        # with stage detail, rows attribute to the hop that actually
        # answered (or lost) them, at that hop's price (DESIGN.md §13)
        w_of = ({j: w for w, j in enumerate(fl.miss)}
                if fl.stage_detail is not None else None)
        for j, i in enumerate(map(int, fl.idx)):
            if j in fl.forced:
                disposition[i] = REJECTED       # policy-rejected, $0
            elif j in miss_set:
                if fl.cached[j] is not None:    # billed remote answer
                    disposition[i] = (REMOTE if accepted[i] else REJECTED)
                    if w_of is None:
                        row_backend[i] = fl.bname
                        row_cost[i] = cost_per
                    else:
                        w = w_of[j]
                        sc = fl.stage_detail["cost"][w]
                        row_backend[i] = str(fl.stage_detail["stage"][w])
                        row_cost[i] = (self.cost.remote_cost_per_request
                                       if np.isnan(sc) else float(sc))
                else:                           # transport-lost, $0
                    disposition[i] = REJECTED
                    if w_of is not None:
                        row_backend[i] = str(
                            fl.stage_detail["stage"][w_of[j]])
                    elif fl.backend is not None:
                        row_backend[i] = fl.bname
            else:                               # cache hit, $0
                disposition[i] = (CACHED if accepted[i] else REJECTED)
                row_backend[i] = (fl.hit_src[j]
                                  if fl.hit_src[j] is not None
                                  else UNATTRIBUTED)

        fl.result = {"prediction": fl.pred, "local_pred": fl.local_pred,
                     "local_conf": fl.conf, "remote_conf": remote_conf,
                     "escalated": escalated, "accepted": accepted,
                     "disposition": disposition, "backend": row_backend,
                     "cost": row_cost}
        if fl.tr is not None:
            # window trace handed to the scheduler, which turns it into
            # one span per request at hand-back (DESIGN.md §9). Row sets
            # tell the span assembly which stage a row went through:
            # remote_rows attempted a billed remote call, hit_rows were
            # served from cache.
            fl.result["trace"] = {
                "window": fl.seq,
                "stages": fl.tr,
                "remote_rows": {int(fl.idx[j]) for j in miss_set},
                "hit_rows": {int(fl.idx[j]) for j in range(fl.k)
                             if j not in miss_set and j not in fl.forced},
            }
        fl.finalized = True

    # -- runtime path: commit half -------------------------------------
    def _commit(self, fl: _InFlight) -> dict[str, np.ndarray]:
        """Fold the finalized window into stats / per-backend billing /
        controller state. Callers MUST commit in submission order — that
        is what keeps streaming accounting bitwise-identical to FIFO."""
        # per-backend billing/latency attribution (DESIGN.md §6): billed
        # calls and failures charge the routed backend; cache hits charge
        # $0 to whichever backend originally filled the entry
        cost_per = self.cost.backend_cost(fl.backend)
        lat_per = self.cost.backend_latency(fl.backend)
        if fl.stage_detail is not None and fl.miss:
            # per-stage billing split (DESIGN.md §13): each fresh row
            # charges the hop that answered it at that hop's price; lost
            # rows charge their failure to the hop whose transport dropped
            # them. The lump-sum path below stays byte-for-byte for plain
            # backends and terminal (degenerate 2-tier) stages.
            sdet = fl.stage_detail
            split: dict[str, list] = {}
            for w, j in enumerate(fl.miss):
                row = split.setdefault(str(sdet["stage"][w]),
                                       [0, 0, 0.0, 0.0])
                if fl.cached[j] is not None:
                    sc, sl = sdet["cost"][w], sdet["latency"][w]
                    row[0] += 1
                    row[2] += (self.cost.remote_cost_per_request
                               if np.isnan(sc) else float(sc))
                    row[3] += (self.cost.remote_latency_s
                               if np.isnan(sl) else float(sl))
                else:
                    row[1] += 1
            fl.stage_split = split
            window_cost = 0.0
            window_lat = 0.0
            for name in sorted(split):
                calls, fails, c, lt = split[name]
                u = self.stats.backend_usage(name)
                u.remote_calls += calls
                u.transport_failures += fails
                u.cost += c
                u.remote_latency_s += lt
                window_cost += c
                window_lat += lt
        else:
            window_cost = fl.n_sent * cost_per
            window_lat = fl.n_sent * lat_per
            if fl.n_sent or fl.n_failed:
                u = self.stats.backend_usage(fl.bname)
                u.remote_calls += fl.n_sent
                u.transport_failures += fl.n_failed
                u.cost += window_cost
                u.remote_latency_s += window_lat
        if fl.n_hits and fl.hit_src is not None:
            miss_set = set(fl.miss)
            for j in range(fl.k):
                # policy-forced REJECTED rows are neither misses nor hits
                if j not in miss_set and j not in fl.forced:
                    src = fl.hit_src[j]
                    self.stats.backend_usage(
                        src if src is not None else UNATTRIBUTED
                    ).cache_hits += 1

        # per-backend agreement-with-local EMA (DESIGN.md §13): on served
        # escalated rows, how often the answering backend's argmax agreed
        # with the local model's — a label-free cross-tier accuracy proxy
        if fl.k > 0:
            rb = fl.result["backend"]
            groups: dict[str, list] = {}
            for j, i in enumerate(map(int, fl.idx)):
                if (j not in fl.forced and i < fl.real
                        and np.isfinite(fl.remote_conf[i])
                        and rb[i] is not None):
                    groups.setdefault(str(rb[i]), []).append(
                        int(fl.pred[i] == fl.local_pred[i]))
            if groups:
                fl.agreement = []
                for name in sorted(groups):
                    rows = groups[name]
                    frac = float(np.mean(rows))
                    u = self.stats.backend_usage(name)
                    u.agreement_rows += len(rows)
                    u.agreement_ema = (
                        frac if u.agreement_ema is None
                        else (1.0 - AGREEMENT_ALPHA) * u.agreement_ema
                        + AGREEMENT_ALPHA * frac)
                    fl.agreement.append((name, len(rows), frac,
                                         u.agreement_ema))

        accepted = fl.result["accepted"]
        # policy-rejected rows never touched a tier past the local model:
        # they are `rejected`, not `escalations` (the billing invariant
        # escalations = remote_calls + cache_hits + transport_failures
        # stays exact — DESIGN.md §8)
        escalations = fl.k - len(fl.forced)
        rejected = int((~accepted[:fl.real]).sum())
        self._account(fl.real, escalations, fl.n_sent, fl.n_hits,
                      fl.n_failed, rejected,
                      cost=window_cost,
                      remote_latency_s=window_lat)
        wall_s = self._clock() - fl.t0
        self.stats.record_wall(wall_s, fl.real)
        if fl.tr is not None:
            fl.tr["commit"] = self._clock()
        if self.observability is not None:
            self._publish_commit(fl, window_cost, escalations, rejected,
                                 wall_s)
            if self.controller is not None:
                self.controller.event_window = fl.seq
        if self.controller is not None:
            self.controller.observe(fl.conf[:fl.real], escalations, fl.real,
                                    fl.remote_conf[:fl.real],
                                    cost=window_cost,
                                    policy_blocked=fl.blocked)
        if self.early_emit:
            # sweep the emitted triple (the host half may have waited on
            # the event before the emitter stored it); a later emit for
            # this window is dropped by _on_gate
            with self._gate_lock:
                self._gate_results.pop(fl.seq, None)
                self._committed_seq = fl.seq
        return fl.result

    def _publish_commit(self, fl: _InFlight, window_cost: float,
                        escalations: int, rejected: int,
                        wall_s: float) -> None:
        """Commit-half metrics/events (observability enabled only).
        Counters update strictly in commit (= submission) order with the
        SAME per-window increments as ``_account``, so the running
        ``cascade_cost_dollars_total`` float is bitwise-identical to
        ``CascadeStats.total_cost`` at every commit boundary."""
        m = self.observability.metrics
        m.counter("cascade_windows_total").inc()
        m.counter("cascade_requests_total").inc(fl.real)
        m.counter("cascade_escalations_total").inc(escalations)
        m.counter("cascade_remote_calls_total").inc(fl.n_sent)
        m.counter("cascade_cache_hits_total").inc(fl.n_hits)
        m.counter("cascade_transport_failures_total").inc(fl.n_failed)
        m.counter("cascade_rejected_total").inc(rejected)
        m.counter("cascade_cost_dollars_total").inc(window_cost)
        names, counts = np.unique(
            fl.result["disposition"][:fl.real].astype(str),
            return_counts=True)
        for d, c in zip(names, counts):
            m.counter("cascade_disposition_total",
                      disposition=str(d)).inc(int(c))
        m.histogram("cascade_window_wall_seconds").observe(wall_s)
        if fl.stage_split is not None:
            for name in sorted(fl.stage_split):
                calls, fails, _c, _lt = fl.stage_split[name]
                if calls:
                    m.counter("cascade_stage_answered_total",
                              stage=name).inc(calls)
                if fails:
                    m.counter("cascade_stage_failures_total",
                              stage=name).inc(fails)
        ev = self.observability.events
        if ev is not None and fl.downgraded:
            for i, d in sorted(fl.downgraded.items()):
                ev.emit(EV_DEADLINE_DOWNGRADE if d == DEADLINE_LOCAL
                        else EV_POLICY_DOWNGRADE,
                        window=fl.seq, row=int(i), disposition=d)
        if ev is not None and fl.stage_split is not None:
            for name in sorted(fl.stage_split):
                calls, fails, c, _lt = fl.stage_split[name]
                ev.emit(EV_STAGE_ANSWER, window=fl.seq, stage=name,
                        answered=calls, failures=fails, cost=c)
        if ev is not None and fl.agreement is not None:
            for name, rows, frac, ema in fl.agreement:
                ev.emit(EV_BACKEND_AGREEMENT, window=fl.seq,
                        backend=name, rows=rows,
                        window_fraction=frac, ema=ema)

    # ------------------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        """Drain any in-flight pipelined/streaming windows (their results
        are accounted but discarded) and shut down every backend's thread
        pool. Half-finalized streaming runs drain too: already-finalized
        windows just commit, the rest finalize first; then the early-emit
        watcher is joined (raising what it kept). Idempotent; a no-op on
        the fused path."""
        try:
            while self._inflight:
                self.complete_next()
        except BaseException as exc:
            self._close_emitter(exc)
            raise
        else:
            self._close_emitter(None)
        finally:
            if self.router is not None:
                self.router.shutdown(wait=wait)

    def _close_emitter(self, drain_error: BaseException | None) -> None:
        """Join the early-emit watcher. What it kept is raised, unless the
        drain already failed: the drain's exception stays the one raised,
        with the watcher's as a note."""
        if self._emitter is None:
            return
        try:
            self._emitter.close()
        except BaseException as err:
            if drain_error is None:
                raise
            drain_error.add_note(f"early-emit watcher: {err!r}")

    def __enter__(self) -> "CascadeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _account(self, real, escalations, remote_calls, cache_hits,
                 transport_failures, rejected, *, cost=None,
                 remote_latency_s=None):
        """Fold one window into the aggregate stats. ``cost`` and
        ``remote_latency_s`` carry per-backend pricing from the runtime
        path; when omitted (fused path) the CostModel defaults apply."""
        if cost is None:
            cost = remote_calls * self.cost.remote_cost_per_request
        if remote_latency_s is None:
            remote_latency_s = remote_calls * self.cost.remote_latency_s
        st = self.stats
        st.requests += real
        st.escalations += escalations
        st.remote_calls += remote_calls
        st.cache_hits += cache_hits
        st.transport_failures += transport_failures
        st.rejected += rejected
        st.total_cost += cost
        st.total_latency_s += (real * self.cost.local_latency_s
                               + remote_latency_s
                               + cache_hits * self.cost.cache_hit_latency_s)
