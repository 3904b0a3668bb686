"""Request scheduler: microbatching queue in front of the cascade engine.

Requests arrive one by one (each carrying both input views); the scheduler
packs fixed-size microbatches (padding the tail with replicas so jitted
shapes never change), runs the engine and routes per-request results,
including the REJECTED -> fallback path (paper Algorithm 1 line 12).
Transport failures surface as REJECTED too (DESIGN.md §3), so an outage
degrades to fallback answers instead of dropped requests.

The queue is a deque (an O(n^2) list-slice drain lived here once); the
engine is told how many rows are genuine (``real_rows``) so padded
replicas are never counted in the stats or billed against the remote tier.

``flush(pipeline_depth=N)`` drives the engine's pipelined runtime path
(DESIGN.md §5): up to N microbatches stay in flight — batch i+1's local
tier runs while batch i's escalations are on the wire — and windows are
drained strictly in submission order, so responses, stats and controller
observations are identical regardless of remote completion order.
``pipeline_depth`` doubles as the backpressure bound: submission stalls
on the oldest window once N are outstanding.

``completion_mode="streaming"`` (DESIGN.md §7) keeps the same pipeline
but hands results back per REQUEST instead of per FIFO window: locally
trusted rows return the moment their window's confidence gate clears;
escalated rows return as their remote futures resolve (out of submission
order when thresholds are static). ``self.responses`` is the reorder-free
response map — responses are keyed by uid at emission, so no reordering
buffer ever exists — and every ``Response`` carries its measured
``latency_s`` (enqueue -> hand-back, consistently for every path).
Billing and controller state stay bitwise-identical to FIFO because the
engine commits accounting in submission order either way (with a
response cache, repeats across concurrently in-flight windows may gain
extra $0 cache hits vs FIFO — see ``CascadeEngine.complete_ready``).

Per-request policy + window packing (DESIGN.md §8): every ``Request``
may carry a ``RequestPolicy`` (deadline SLA, cost cap, routing hint,
escalation override); the scheduler forwards policies and enqueue stamps
to the engine, and each ``Response`` reports ``disposition`` /
``backend`` / ``cost`` — how the request was actually served and what it
was billed. With ``packing="policy"`` the scheduler classifies each
request at submit time — can it possibly go remote (policy feasibility
against the router's price/latency estimates), and is it *likely* to
(the calibration-table escalation ``prior``)? — and packs HOT
(likely-escalating) and COLD (trusted-local / policy-pinned) rows into
separate windows, draining cold windows first: trusted-local rows never
share a window with a remote round trip, and deadline-pinned rows don't
queue behind one. Windows are never mixed (the tail of each class is
padded instead); ``packing_stats`` reports the realised purity.

Overload admission control (DESIGN.md §10): with ``admission_limit > 0``
the queue is bounded. ``submit`` evaluates three rules before enqueueing
— hard bound (queue full → SHED), soft watermark (queue past
``admission_soft_ratio``·limit → apply the request's ``on_miss``:
``fallback`` degrades it to local-only, ``reject`` sheds), and deadline
feasibility (expected queue wait from the engine's window-service EMA
plus the fastest backend RTT exceeds the remaining deadline → same
``on_miss`` split). A shed request is answered *immediately* from the
fallback with the ``SHED`` disposition, $0 cost and ``source="shed"`` —
never enqueued, never billed, never silently dropped: shed responses are
recorded in ``self.responses`` at submit and included in the next
``flush`` output, so ``submitted == len(responses)`` still holds and
``AdmissionStats.submitted == engine.stats.requests + shed`` reconciles
with billing exactly.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.runtime.observability import (EV_ADMISSION_DEGRADE,
                                         EV_ADMISSION_SHED, span)
from repro_torch.serving.policy import (BATCHING_MODES, CACHED, LOCAL, REJECTED,
                                  REMOTE, SHED, RequestPolicy, ServeConfig)

COMPLETION_MODES = ("fifo", "streaming")


def _stack(items):
    """Stack a list of (possibly pytree) request inputs into a batch."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return np.stack(items)


@dataclass
class Request:
    uid: int
    local_input: np.ndarray
    remote_input: np.ndarray
    policy: RequestPolicy | None = None   # per-request contract (§8)
    t_enq: float = 0.0                    # stamped at submit()


@dataclass
class Response:
    uid: int
    prediction: int
    source: str               # "local" | "remote" | "fallback"
    local_conf: float
    remote_conf: float
    latency_s: float = 0.0    # measured: enqueue -> hand-back
    disposition: str = LOCAL  # how the row was served (DESIGN.md §8)
    backend: str | None = None  # backend billed/attributed (None = local)
    cost: float = 0.0         # realised $ billed for this request
    # enqueue -> window dispatch: the load-dependent share of latency_s.
    # latency_s - queue_s is the SERVICE latency (dispatch -> hand-back),
    # the basis of the streaming trusted-local-vs-FIFO comparison
    queue_s: float = 0.0


@dataclass
class AdmissionStats:
    """Overload admission accounting (DESIGN.md §10). Reconciliation:
    ``submitted == admitted + shed`` and, once every admitted request is
    flushed, ``admitted == engine.stats.requests`` — so shed + served +
    rejected counts tie out bitwise against ``CascadeStats`` billing."""
    submitted: int = 0          # submit() calls seen
    admitted: int = 0           # enqueued (includes degraded)
    degraded: int = 0           # admitted pinned local by overload rules
    shed: int = 0               # refused, answered via fallback (SHED)
    shed_reasons: dict = field(default_factory=dict)     # reason -> n
    degrade_reasons: dict = field(default_factory=dict)  # reason -> n


class _Window:
    """Scheduler-side bookkeeping for one in-flight microbatch."""

    __slots__ = ("chunk", "fl", "t_disp", "emitted", "host_emitted",
                 "early_emitted", "left")

    def __init__(self, chunk, fl, t_disp):
        self.chunk = chunk
        self.fl = fl
        self.t_disp = t_disp            # window dispatch stamp (queue_s)
        self.emitted: set[int] = set()  # rows already handed back
        self.host_emitted = False       # host-half emission pass done
        self.early_emitted = False      # pre-decided cache hits handed back
        self.left = 0                   # rows already freed in the slot map


class _SlotMap:
    """Slot-occupancy ledger for the continuous batcher (DESIGN.md §11).

    The continuous serve loop admits dispatch cohorts against FREE SLOTS
    of a persistent padded batch (``batch_size × pipeline_depth`` rows)
    instead of counting whole in-flight windows: a row occupies its slot
    from dispatch until its response is handed back, so a cohort of
    trusted-local rows returns its slots at *gate* time and admission
    reopens while the window's escalations are still on the wire. The
    occupancy-fraction EMA is the admission/deadline-feasibility signal
    (`_queue_wait_estimate`) — the continuous analogue of queue depth in
    windows."""

    __slots__ = ("capacity", "occupied", "peak", "joins", "leaves",
                 "occupancy_ema", "_alpha")

    def __init__(self, capacity: int, alpha: float = 0.2):
        self.capacity = max(1, capacity)
        self.occupied = 0
        self.peak = 0
        self.joins = 0
        self.leaves = 0
        self.occupancy_ema = 0.0
        self._alpha = alpha

    @property
    def free(self) -> int:
        return self.capacity - self.occupied

    def join(self, n: int) -> None:
        self.occupied += n
        self.joins += n
        if self.occupied > self.peak:
            self.peak = self.occupied
        self._observe()

    def leave(self, n: int) -> None:
        self.occupied -= n
        self.leaves += n
        self._observe()

    def _observe(self) -> None:
        frac = self.occupied / self.capacity
        self.occupancy_ema += self._alpha * (frac - self.occupancy_ema)


class MicrobatchScheduler:
    def __init__(self, engine, fallback: Callable[[Request], int] | None = None,
                 pipeline_depth: int = 1, completion_mode: str = "fifo",
                 packing: str = "none",
                 prior: Callable[[Request], float] | None = None,
                 admission_limit: int = 0,
                 admission_soft_ratio: float = 0.5,
                 batching: str = "window",
                 admission_share: Callable[[], float] | None = None):
        if completion_mode not in COMPLETION_MODES:
            raise ValueError(f"unknown completion_mode {completion_mode!r};"
                             f" choose from {COMPLETION_MODES}")
        if packing not in ("none", "policy"):
            raise ValueError(f"unknown packing {packing!r}")
        if packing != "none" and engine.transport is None:
            raise ValueError("window packing needs the runtime path")
        if admission_limit and engine.transport is None:
            raise ValueError("admission control needs the runtime path")
        if batching not in BATCHING_MODES:
            raise ValueError(f"unknown batching {batching!r}; "
                             f"choose from {BATCHING_MODES}")
        if batching == "continuous":
            if engine.transport is None:
                raise ValueError("continuous batching needs the runtime "
                                 "path")
            if completion_mode != "streaming":
                raise ValueError("batching='continuous' requires "
                                 "completion_mode='streaming'")
        self.engine = engine
        self.fallback = fallback
        self.pipeline_depth = max(1, pipeline_depth)
        self.completion_mode = completion_mode
        self.batching = batching
        # slot-occupancy ledger (continuous only; DESIGN.md §11) — also
        # the admission/deadline-feasibility signal between flushes
        self._slots = (_SlotMap(engine.batch_size * self.pipeline_depth)
                       if batching == "continuous" else None)
        # span-stage vocabulary: continuous rows JOIN the slot map (and
        # may carry an early EMIT stage); window rows are packed
        self._pack_stage = "join" if batching == "continuous" else "pack"
        if completion_mode == "streaming":
            # we consume fl.early (cache hits handed back at gate-clear);
            # FIFO consumers leave it off and skip the extra host pass
            engine.early_handback = True
        self.packing = packing
        # P(escalate | request): the calibration-table prior driving the
        # HOT/COLD split (repro.runtime.fit_escalation_prior). None =
        # classify by policy feasibility alone (DESIGN.md §8)
        self.prior = prior
        self.prior_threshold = 0.5
        self.queue: deque[Request] = deque()      # HOT / default queue
        self.cold: deque[Request] = deque()       # trusted-local-bound
        self.responses: dict[int, Response] = {}
        self.fallbacks = 0
        # overload admission control (DESIGN.md §10; 0 = unbounded)
        self.admission_limit = max(0, admission_limit)
        self.admission_soft = (max(1, int(self.admission_limit
                                          * admission_soft_ratio))
                               if self.admission_limit else 0)
        self.admission = AdmissionStats()
        # cluster-aware admission (DESIGN.md §12): a callable returning
        # this replica's current budget share (1.0 = fair share). The
        # soft watermark scales with it, so a replica the cluster
        # reconciler has squeezed sheds/degrades earlier while one
        # granted headroom rides closer to its hard bound. None (the
        # single-replica default) leaves the watermark fixed.
        self.admission_share = admission_share
        self._shed_out: list[Response] = []       # shed since last flush
        # window purity telemetry (packing="policy" only): windows are
        # pure by construction; `mixed` staying 0 is the invariant the
        # serving bench gates (DESIGN.md §8)
        self.packing_stats = {"windows": 0, "cold": 0, "hot": 0, "mixed": 0}
        # time from flush start to the first response handed back (the
        # streaming mode's headline telemetry; tracked for FIFO too)
        self.first_response_s: float | None = None
        self._flush_t0: float = 0.0
        self._clock = engine._clock
        # observability (DESIGN.md §9): memoized per-response latency
        # histogram handle; resolved lazily so installing the facade
        # after scheduler construction still works. None while disabled.
        self._lat_hist = None

    @classmethod
    def from_config(cls, engine, config: ServeConfig, *,
                    fallback: Callable[[Request], int] | None = None,
                    prior: Callable[[Request], float] | None = None,
                    admission_share: Callable[[], float] | None = None
                    ) -> "MicrobatchScheduler":
        """Build the scheduler from the one ``ServeConfig`` facade
        (DESIGN.md §8) — the supported construction path."""
        return cls(engine, fallback=fallback,
                   pipeline_depth=config.pipeline_depth,
                   completion_mode=config.completion_mode,
                   packing=config.packing, prior=prior,
                   admission_limit=config.admission_limit,
                   admission_soft_ratio=config.admission_soft_ratio,
                   batching=config.batching,
                   admission_share=admission_share)

    # -- admission ------------------------------------------------------
    def submit(self, req: Request) -> Response | None:
        """Enqueue one request. With admission control enabled the
        overload rules run first; a shed request is answered *here* —
        the SHED ``Response`` is returned (and re-delivered in the next
        ``flush`` output, so callers that only collect flush results
        still see every submission exactly once)."""
        if req.t_enq == 0.0:
            req.t_enq = self._clock()   # the deadline/latency anchor
        self.admission.submitted += 1
        if self.admission_limit:
            action, reason = self._admit(req)
            if action == "shed":
                return self._shed(req, reason)
            if action == "degrade":
                self._degrade(req, reason)
        self.admission.admitted += 1
        if self.packing == "policy":
            # the label sticks to the REQUEST so window purity is
            # measured from the rows actually dispatched together, not
            # from which queue a chunk was drawn from (a cross-queue
            # mixing bug must show up as `mixed`, not be defined away)
            req._pack_class = self._classify(req)
            (self.cold if req._pack_class == "cold"
             else self.queue).append(req)
        else:
            self.queue.append(req)
        return None

    # -- overload admission control (DESIGN.md §10) ---------------------
    def _admit(self, req: Request) -> tuple[str, str | None]:
        """Admission decision: ``("admit"|"degrade"|"shed", reason)``.
        Hard bound first (queue full always sheds — a degrade cannot
        bound memory), then the soft watermark and deadline-feasibility
        rules, both of which resolve through the request's ``on_miss``
        vocabulary: ``fallback`` degrades to local-only, ``reject``
        sheds."""
        depth = self._qsize()
        if depth >= self.admission_limit:
            return "shed", "queue_full"
        pol = (req.policy if req.policy is not None
               else self.engine.default_policy)
        on_miss = pol.on_miss if pol is not None else "fallback"
        miss = "shed" if on_miss == "reject" else "degrade"
        if depth >= self._soft_watermark():
            return miss, "overload"
        if pol is not None and pol.deadline_s is not None:
            wait = self._queue_wait_estimate(depth)
            if wait is not None:
                remaining = pol.deadline_s - (self._clock() - req.t_enq)
                est = (self.engine.router.min_latency_estimate(
                           max_cost=pol.cost_cap,
                           default_cost=self.engine.cost
                           .remote_cost_per_request)
                       if pol.escalation != "never" else None)
                if wait + (est or 0.0) > remaining:
                    # a local-only row that already can't make it only
                    # sheds (degrading is a no-op for it)
                    if est is None and miss == "degrade":
                        return "admit", None
                    return miss, "deadline"
        return "admit", None

    def _soft_watermark(self) -> int:
        """Soft admission watermark, scaled by the replica's cluster
        budget share when one is wired (DESIGN.md §12). The scale is
        clamped to [0.25, 4.0] so a pathological share can neither
        disable soft admission nor override the hard bound, and the
        result stays >= 1 and <= admission_limit - 1 (the hard bound
        must remain reachable only through genuine queue growth)."""
        soft = self.admission_soft
        if self.admission_share is None or not soft:
            return soft
        scale = min(max(float(self.admission_share()), 0.25), 4.0)
        soft = max(1, int(round(soft * scale)))
        return min(soft, max(self.admission_limit - 1, 1))

    def _queue_wait_estimate(self, depth: int) -> float | None:
        """Expected time for a request joining behind ``depth`` queued
        rows to clear its own window: full windows ahead of it plus its
        own, priced at the engine's measured window-service EMA. None
        until a window has committed (no estimate beats a fabricated
        one).

        Continuous batching (DESIGN.md §11) prices against SLOT occupancy
        instead: rows already holding slots are ahead of the queue, but
        up to ``pipeline_depth`` cohorts drain concurrently, so the
        window count amortizes over the pipeline width — an idle slot map
        collapses the estimate to one window's EMA, a saturated one
        degrades toward the windowed bound."""
        ema = self.engine.stats.window_service_ema_s
        if ema is None:
            return None
        b = self.engine.batch_size
        if self._slots is not None:
            rows_ahead = depth + self._slots.occupied
            return ema * (1.0 + (rows_ahead // b) / self.pipeline_depth)
        return (depth // b + 1) * ema

    def _shed(self, req: Request, reason: str) -> Response:
        """Refuse ``req`` at admission: answer immediately from the
        fallback with the SHED disposition ($0, never enqueued). The
        response is recorded now and re-delivered by the next flush
        (zero-silent-drop: flush output covers every submission)."""
        self.admission.shed += 1
        self.admission.shed_reasons[reason] = (
            self.admission.shed_reasons.get(reason, 0) + 1)
        pred = self.fallback(req) if self.fallback else -1
        now = self._clock()
        resp = Response(req.uid, pred, "shed", 0.0, 0.0,
                        latency_s=now - req.t_enq, disposition=SHED,
                        backend=None, cost=0.0, queue_s=0.0)
        self.responses[resp.uid] = resp
        self._shed_out.append(resp)
        obs = self.engine.observability
        if obs is not None:
            obs.metrics.counter("cascade_admission_shed_total",
                                reason=reason).inc()
            if obs.events is not None:
                obs.events.emit(EV_ADMISSION_SHED, uid=req.uid,
                                reason=reason, depth=self._qsize(),
                                limit=self.admission_limit)
        return resp

    def _degrade(self, req: Request, reason: str) -> None:
        """Admit ``req`` pinned to the local tier: its policy is replaced
        with an ``escalation="never"`` copy, so the engine serves it as
        POLICY_LOCAL — load is shed from the *remote* tier while the
        request still gets its local answer (the ``on_miss="fallback"``
        arm of the overload rules)."""
        self.admission.degraded += 1
        self.admission.degrade_reasons[reason] = (
            self.admission.degrade_reasons.get(reason, 0) + 1)
        base = (req.policy if req.policy is not None
                else self.engine.default_policy) or RequestPolicy()
        req.policy = dataclasses.replace(base, escalation="never")
        obs = self.engine.observability
        if obs is not None:
            obs.metrics.counter("cascade_admission_degraded_total",
                                reason=reason).inc()
            if obs.events is not None:
                obs.events.emit(EV_ADMISSION_DEGRADE, uid=req.uid,
                                reason=reason, depth=self._qsize(),
                                limit=self.admission_limit)

    def _drain_shed(self) -> list[Response]:
        out, self._shed_out = self._shed_out, []
        return out

    def _can_escalate(self, pol: RequestPolicy, t_enq: float) -> bool:
        """Submit-time feasibility mirror of the engine's policy pass:
        could this request possibly be served remotely? (The engine
        re-checks authoritatively at the window's host half.)"""
        if pol.escalation == "never":
            return False
        router = self.engine.router
        default_cost = self.engine.cost.remote_cost_per_request
        if pol.cost_cap is not None:
            mc = router.min_available_cost(default_cost)
            if mc is None or mc > pol.cost_cap + 1e-12:
                return False
        if pol.deadline_s is not None:
            est = router.min_latency_estimate(max_cost=pol.cost_cap,
                                              default_cost=default_cost)
            remaining = pol.deadline_s - (self._clock() - t_enq)
            if est is None or est > remaining:
                return False
        return True

    def _classify(self, req: Request) -> str:
        """HOT (may ride a remote round trip) vs COLD (stays local):
        policy feasibility first, then the escalation-likelihood prior."""
        pol = (req.policy if req.policy is not None
               else self.engine.default_policy)
        if pol is not None and not pol.is_default:
            if not self._can_escalate(pol, req.t_enq):
                return "cold"
            if pol.escalation == "always":
                return "hot"
        if self.prior is not None:
            return ("hot" if self.prior(req) >= self.prior_threshold
                    else "cold")
        return "hot"

    # -- chunking -------------------------------------------------------
    def _qsize(self) -> int:
        return len(self.queue) + len(self.cold)

    def _pad(self, reqs: list[Request]) -> list[Request]:
        b = self.engine.batch_size
        return reqs + [reqs[-1]] * (b - len(reqs))

    def _next_chunk(self) -> tuple[list[Request], dict[str, Any]]:
        b = self.engine.batch_size
        # cold windows drain first (deadline-pinned / trusted-local rows
        # must not queue behind remote round trips) and classes never
        # share a window — short tails are padded, not mixed (§8)
        src = self.cold if self.cold else self.queue
        chunk = [src.popleft() for _ in range(min(b, len(src)))]
        if self.packing == "policy":
            classes = {getattr(r, "_pack_class", "hot") for r in chunk}
            self.packing_stats["windows"] += 1
            self.packing_stats[classes.pop() if len(classes) == 1
                               else "mixed"] += 1
        padded = self._pad(chunk)
        batch = {
            "local": _stack([r.local_input for r in padded]),
            "remote": _stack([r.remote_input for r in padded]),
        }
        return chunk, batch

    @staticmethod
    def _serve_args(chunk: list[Request]) -> dict[str, Any]:
        """policies/t_enq kwargs for the engine (omitted when no row in
        the chunk carries a policy — the unpolicied fast path)."""
        if all(r.policy is None for r in chunk):
            return {"t_enq": [r.t_enq for r in chunk]}
        return {"policies": [r.policy for r in chunk],
                "t_enq": [r.t_enq for r in chunk]}

    # -- hand-back ------------------------------------------------------
    def _record(self, resp: Response, out: list[Response]) -> None:
        """Reorder-free hand-back: key by uid, never buffer for order."""
        if self.first_response_s is None:
            self.first_response_s = self._clock() - self._flush_t0
        self.responses[resp.uid] = resp
        out.append(resp)
        obs = self.engine.observability
        if obs is not None:
            h = self._lat_hist
            if h is None:
                h = self._lat_hist = obs.metrics.histogram(
                    "cascade_request_latency_seconds")
            h.observe(resp.latency_s)

    # -- per-request trace spans (DESIGN.md §9) ------------------------
    def _emit_span(self, resp: Response, req: Request, t_disp: float,
                   tr: dict, window: int, handback: float, *,
                   remote: bool, hit: bool,
                   emit_ts: float | None = None) -> None:
        """Assemble one request's span timeline from its window's stage
        stamps. Stages are appended in canonical ``SPAN_STAGES`` order —
        enqueue → pack/join → dispatch → gate → route → cache_hit/remote
        → commit → emit → hand-back — and each stamp was taken later than
        the one before it, so timestamps are nondecreasing by
        construction. ``commit`` is present whenever the window committed
        before the row was handed back (always true for sync/FIFO drains;
        absent for streaming rows emitted ahead of their window's
        commit). Continuous-batching rows join a slot instead of packing
        a window (``join`` stage) and trusted-local rows surfaced at gate
        time carry an ``emit`` stage (DESIGN.md §11)."""
        stages = [["enqueue", req.t_enq], [self._pack_stage, t_disp],
                  ["dispatch", tr["dispatch"]]]
        if "gate" in tr:
            stages.append(["gate", tr["gate"]])
        if (remote or hit) and "route" in tr:
            stages.append(["route", tr["route"]])
            if hit:
                # the lookup happened inside the gate→route interval;
                # the route stamp is its completion time
                stages.append(["cache_hit", tr["route"]])
        if remote and "remote" in tr:
            stages.append(["remote", tr["remote"]])
        if "commit" in tr:
            stages.append(["commit", tr["commit"]])
        if emit_ts is not None:
            stages.append(["emit", emit_ts])
        stages.append(["handback", handback])
        self.engine.observability.trace.emit({
            "uid": resp.uid, "window": window,
            "disposition": resp.disposition, "backend": resp.backend,
            "cost": resp.cost, "source": resp.source,
            "t_local_gate": tr.get("t_local"),
            "t_remote_gate": tr.get("t_remote"),
            "stages": stages,
        })

    def _tracing(self) -> bool:
        obs = self.engine.observability
        return obs is not None and obs.trace is not None

    def _route(self, chunk: list[Request], res: dict,
               t_disp: float) -> list[Response]:
        out: list[Response] = []
        now = self._clock()
        dispo = res.get("disposition")
        backend = res.get("backend")
        cost = res.get("cost")
        trace = res.get("trace") if self._tracing() else None
        for i, req in enumerate(chunk):
            escalated = bool(res["escalated"][i])
            accepted = bool(res["accepted"][i])
            if not escalated:
                src = "local"
                pred = int(res["local_pred"][i])
            elif accepted:
                src = "remote"
                pred = int(res["prediction"][i])
            else:
                src = "fallback"
                self.fallbacks += 1
                pred = (self.fallback(req) if self.fallback
                        else -1)  # "raise Exception" analogue
            if dispo is not None:
                d, b, c = dispo[i], backend[i], float(cost[i])
            else:
                # fused path: derive attribution from the routing masks
                d = LOCAL if not escalated else (REMOTE if accepted
                                                 else REJECTED)
                b = None
                c = (self.engine.cost.remote_cost_per_request
                     if escalated else 0.0)
            resp = Response(req.uid, pred, src,
                            float(res["local_conf"][i]),
                            float(res["remote_conf"][i]),
                            latency_s=now - req.t_enq,
                            disposition=d, backend=b, cost=c,
                            queue_s=t_disp - req.t_enq)
            self._record(resp, out)
            if trace is not None:
                self._emit_span(resp, req, t_disp, trace["stages"],
                                trace["window"], now,
                                remote=i in trace["remote_rows"],
                                hit=i in trace["hit_rows"])
        return out

    def flush(self, pipeline_depth: int | None = None) -> list[Response]:
        depth = (self.pipeline_depth if pipeline_depth is None
                 else max(1, pipeline_depth))
        self.first_response_s = None
        self._flush_t0 = self._clock()
        # requests shed at admission since the last flush lead the output
        # (they were answered at submit; re-delivering here keeps "flush
        # returns every submission exactly once" true for every caller)
        shed = self._drain_shed()
        if self.engine.transport is not None:
            if self.batching == "continuous":
                return shed + self._flush_continuous(depth)
            if self.completion_mode == "streaming":
                return shed + self._flush_streaming(depth)
            if depth > 1:
                return shed + self._flush_pipelined(depth)
        out: list[Response] = shed
        while self._qsize():
            with span("cascade.window"):
                chunk, batch = self._next_chunk()
                t_disp = self._clock()
                res = self.engine.serve(batch, real_rows=len(chunk),
                                        **self._serve_args(chunk))
                out.extend(self._route(chunk, res, t_disp))
        return out

    def _check_exclusive_engine(self) -> None:
        if self.engine.inflight:
            # windows begun outside this flush (or left over from an
            # aborted one) would silently pair with the wrong requests
            raise RuntimeError(f"engine has {self.engine.inflight} "
                               "in-flight windows not owned by this "
                               "scheduler; drain complete_next() first")

    def _flush_pipelined(self, depth: int) -> list[Response]:
        """Overlapped drain: keep up to ``depth`` microbatches in flight,
        completing the oldest (FIFO) whenever the window is full or the
        queue is empty. Responses come back in submission order."""
        self._check_exclusive_engine()
        out: list[Response] = []
        pending: deque[tuple[list[Request], float]] = deque()
        while self._qsize() or pending:
            with span("cascade.window"):
                while self._qsize() and len(pending) < depth:
                    chunk, batch = self._next_chunk()
                    t_disp = self._clock()
                    self.engine.begin_serve(batch, real_rows=len(chunk),
                                            **self._serve_args(chunk))
                    pending.append((chunk, t_disp))
                # about to block on the oldest window: unpark the double-
                # buffered newest one first, so its remote submission (and in
                # streaming mode its trusted-local rows) never waits out a
                # full drain
                self.engine.flush_dispatch()
                res = self.engine.complete_next()
                chunk, t_disp = pending.popleft()
                out.extend(self._route(chunk, res, t_disp))
        return out

    # -- streaming completion mode (DESIGN.md §7) ----------------------
    def _flush_streaming(self, depth: int) -> list[Response]:
        """Per-request drain: locally-trusted rows hand back as soon as
        their window's host half runs (confidence gate cleared); escalated
        rows hand back when their window finalizes. With static thresholds
        windows finalize out of submission order via ``complete_ready``;
        with a live controller the drain uses ``complete_next`` so the
        begin/commit interleaving — hence every threshold each window
        sees — reproduces the FIFO drain exactly. Either way the engine
        commits accounting in submission order, so billing, per-backend
        attribution and controller state are bitwise-identical to FIFO."""
        self._check_exclusive_engine()
        out: list[Response] = []
        windows: dict[int, _Window] = {}        # seq -> bookkeeping
        fifo_drain = self.engine.controller is not None

        def emit_ready_locals():
            for w in windows.values():
                if not w.host_emitted and w.fl.host_done:
                    self._emit_locals(w, out)

        def emit_window(seq, res):
            w = windows.pop(seq)
            if not w.host_emitted:      # host half ran at the finalize
                self._emit_locals(w, out)
            self._emit_escalated(w, res, out)

        while self._qsize() or windows:
            with span("cascade.window"):
                while self._qsize() and self.engine.inflight < depth:
                    chunk, batch = self._next_chunk()
                    t_disp = self._clock()
                    fl = self.engine.begin_serve(batch, real_rows=len(chunk),
                                                 **self._serve_args(chunk))
                    windows[fl.seq] = _Window(chunk, fl, t_disp)
                    emit_ready_locals()     # previous window's host half ran
                    if not fifo_drain:
                        for seq, res in self.engine.complete_ready():
                            emit_window(seq, res)
                # about to block: unpark the newest window so its remote
                # round trip starts and its trusted-local rows emit NOW
                # instead of after the next drain wave
                self.engine.flush_dispatch()
                emit_ready_locals()
                if not windows:
                    break
                if fifo_drain:
                    res = self.engine.complete_next()
                    emit_window(min(windows), res)      # FIFO = lowest seq
                else:
                    for seq, res in self.engine.complete_ready(block=True):
                        emit_window(seq, res)
        return out

    # -- continuous batching (DESIGN.md §11) ---------------------------
    def _flush_continuous(self, depth: int) -> list[Response]:
        """Slot-map serve loop: dispatch cohorts join free slots of a
        persistent ``batch_size × depth`` padded batch and every row
        leaves its slot the moment its response is handed back. Two
        deltas against the streaming window drain, neither of which
        touches what is served:

        * each cohort's host half runs IMMEDIATELY after its dispatch
          (``flush_dispatch`` after every ``begin_serve`` instead of only
          before blocking), so a trusted-local row's service time is the
          gate time — the in-kernel early emit lands the gate triple on
          the host as the scoring pass clears, and the hand-back happens
          before the next cohort is even formed;
        * without a live controller, admission is keyed on FREE SLOTS
          rather than in-flight window count: a cohort of trusted locals
          returns its slots at gate time and the loop admits the next
          cohort while earlier escalations are still on the wire (the
          row-level backpressure bound is the slot capacity, not
          ``depth`` windows).

        Cohorts are still drawn cold-first exactly like ``_next_chunk``
        (hot/cold are slot-priority classes; the never-mixed invariant is
        per dispatch cohort), and the engine still commits accounting in
        submission order — so predictions, billing and controller
        observations are bitwise-identical to ``batching="window"``. With
        a live controller the admission bound stays ``depth`` in-flight
        windows so the begin/commit interleaving (hence every threshold
        snapshot) reproduces the windowed streaming drain exactly. One
        caveat matches the documented streaming-vs-FIFO one: because host
        halves run one begin EARLIER than the windowed drain, a response
        cache can resolve lookups against a younger cache state — billing
        identity is exact for cacheless runs (DESIGN.md §11)."""
        self._check_exclusive_engine()
        out: list[Response] = []
        windows: dict[int, _Window] = {}        # seq -> bookkeeping
        fifo_drain = self.engine.controller is not None
        slots = self._slots
        slots.capacity = max(1, self.engine.batch_size * depth)

        def sync_slots(w: _Window) -> None:
            freed = len(w.emitted) - w.left
            if freed > 0:
                slots.leave(freed)
                w.left = len(w.emitted)

        def emit_ready_locals():
            for w in windows.values():
                if not w.host_emitted and w.fl.gate_done:
                    self._emit_locals(w, out)
                    sync_slots(w)
                elif (w.host_emitted and not w.early_emitted
                        and w.fl.host_done and w.fl.early):
                    # pre-decided cache hits surface at the submit half,
                    # AFTER the gate-time local emission pass
                    self._emit_early_hits(w, out)
                    sync_slots(w)

        def emit_window(seq, res):
            w = windows.pop(seq)
            if not w.host_emitted:      # host half ran at the finalize
                self._emit_locals(w, out)
            self._emit_escalated(w, res, out)
            sync_slots(w)

        def admissible() -> bool:
            if fifo_drain:
                return self.engine.inflight < depth
            return slots.free >= self.engine.batch_size

        while self._qsize() or windows:
            with span("cascade.window"):
                while self._qsize() and admissible():
                    chunk, batch = self._next_chunk()
                    t_disp = self._clock()
                    fl = self.engine.begin_serve(batch, real_rows=len(chunk),
                                                 **self._serve_args(chunk))
                    windows[fl.seq] = _Window(chunk, fl, t_disp)
                    slots.join(len(chunk))
                    # run this cohort's GATE half NOW (triple fetch + policy
                    # pass only — the early-emitted triple is already on the
                    # host) and hand its trusted locals back before the
                    # escalations' cache/routing/remote submission even runs;
                    # flush_dispatch then completes the submit half
                    self.engine.flush_gate()
                    emit_ready_locals()
                    self.engine.flush_dispatch()
                    emit_ready_locals()
                    if not fifo_drain:
                        for seq, res in self.engine.complete_ready():
                            emit_window(seq, res)
                self.engine.flush_dispatch()
                emit_ready_locals()
                if not windows:
                    break
                if fifo_drain:
                    res = self.engine.complete_next()
                    emit_window(min(windows), res)      # FIFO = lowest seq
                else:
                    for seq, res in self.engine.complete_ready(block=True):
                        emit_window(seq, res)
        return out

    def _emit_locals(self, w: _Window, out: list[Response]) -> None:
        """Hand back every row decidable at the window's host half: the
        locally-trusted rows (gate cleared), policy/deadline downgrades
        (served locally by construction — DESIGN.md §8) and pre-decided
        cache hits (``fl.early``; no remote round trip to wait for — the
        §8 latency fix: their hand-back no longer includes the window
        drain)."""
        fl = w.fl
        now = self._clock()
        tr = fl.tr if self._tracing() else None
        esc = {int(j) for j in fl.idx} if fl.k else set()
        for i, req in enumerate(w.chunk):
            if i in esc or i in w.emitted:
                continue
            resp = Response(req.uid, int(fl.local_pred[i]), "local",
                            float(fl.conf[i]), float("inf"),
                            latency_s=now - req.t_enq,
                            disposition=fl.downgraded.get(i, LOCAL),
                            queue_s=w.t_disp - req.t_enq)
            self._record(resp, out)
            if tr is not None:
                self._emit_span(resp, req, w.t_disp, tr, fl.seq, now,
                                remote=False, hit=False,
                                emit_ts=(now if self._slots is not None
                                         else None))
            w.emitted.add(i)
        w.host_emitted = True
        if fl.host_done:
            # window/streaming drains run the whole host half at once, so
            # pre-decided cache hits are known here; the continuous loop
            # emits at GATE time (before the submit half) and offers the
            # hits in a later ``emit_ready_locals`` pass instead
            self._emit_early_hits(w, out)

    def _emit_early_hits(self, w: _Window, out: list[Response]) -> None:
        """Hand back the window's pre-decided cache hits (``fl.early`` —
        no remote round trip to wait for; the §8 latency fix)."""
        fl = w.fl
        now = self._clock()
        tr = fl.tr if self._tracing() else None
        for e in fl.early:
            i = e["row"]
            if i in w.emitted or i >= len(w.chunk):
                continue
            req = w.chunk[i]
            if e["accepted"]:
                resp = Response(req.uid, e["prediction"], "remote",
                                float(fl.conf[i]), e["remote_conf"],
                                latency_s=now - req.t_enq,
                                disposition=CACHED, backend=e["backend"],
                                cost=e["cost"],
                                queue_s=w.t_disp - req.t_enq)
            else:
                self.fallbacks += 1
                pred = self.fallback(req) if self.fallback else -1
                resp = Response(req.uid, pred, "fallback",
                                float(fl.conf[i]), e["remote_conf"],
                                latency_s=now - req.t_enq,
                                disposition=REJECTED, backend=e["backend"],
                                cost=e["cost"],
                                queue_s=w.t_disp - req.t_enq)
            self._record(resp, out)
            if tr is not None:
                self._emit_span(resp, req, w.t_disp, tr, fl.seq, now,
                                remote=False, hit=True)
            w.emitted.add(i)
        w.early_emitted = True

    def _emit_escalated(self, w: _Window, res: dict,
                        out: list[Response]) -> None:
        """Hand back the window's escalated rows once finalized."""
        fl = w.fl
        now = self._clock()
        trace = res.get("trace") if self._tracing() else None
        for j in fl.idx:
            i = int(j)
            if i in w.emitted:
                continue                # handed back at the host half
            req = w.chunk[i]            # idx only covers genuine rows
            d, b, c = (res["disposition"][i], res["backend"][i],
                       float(res["cost"][i]))
            if bool(res["accepted"][i]):
                resp = Response(req.uid, int(res["prediction"][i]),
                                "remote", float(res["local_conf"][i]),
                                float(res["remote_conf"][i]),
                                latency_s=now - req.t_enq,
                                disposition=d, backend=b, cost=c,
                                queue_s=w.t_disp - req.t_enq)
            else:
                self.fallbacks += 1
                pred = self.fallback(req) if self.fallback else -1
                resp = Response(req.uid, pred, "fallback",
                                float(res["local_conf"][i]),
                                float(res["remote_conf"][i]),
                                latency_s=now - req.t_enq,
                                disposition=d, backend=b, cost=c,
                                queue_s=w.t_disp - req.t_enq)
            self._record(resp, out)
            if trace is not None:
                self._emit_span(resp, req, w.t_disp, trace["stages"],
                                trace["window"], now,
                                remote=i in trace["remote_rows"],
                                hit=i in trace["hit_rows"])
            w.emitted.add(i)
