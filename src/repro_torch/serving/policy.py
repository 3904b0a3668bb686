"""Per-request policy API + the serving configuration facade (DESIGN.md §8).

BiSupervised's value proposition is per-input triage — trust the local
model when the first supervisor clears it, pay for the remote only when
needed (paper §1) — yet until this layer existed every serving knob was
*process-wide*: budget, routing, completion mode and timeouts lived in
~20 ``serve.py`` flags and four constructors. Weiss & Tonella's
uncertainty-quantification recommendations stress that the right supervision
trade-off is workload-dependent; this module makes it **request**-
dependent:

* ``RequestPolicy`` — the per-request contract attached to a
  ``Request``: a latency SLA (``deadline_s``), a spend ceiling
  (``cost_cap``), a backend preference (``routing_hint``), an escalation
  override (``auto`` / ``never`` / ``always``) and the miss behaviour
  (``fallback`` serves the local prediction, ``reject`` takes the
  REJECTED path).
* ``ServeConfig`` — one immutable facade subsuming the flag/constructor
  sprawl: ``serve.py`` builds exactly one and every runtime component
  (``CascadeEngine``, ``MicrobatchScheduler``, ``RemoteRouter``, the
  budget controller, the response cache, the observability layer) is
  constructed *from* it. The keyword constructors remain as the
  low-level composition-root API for tests and bespoke wiring.

Dispositions (``Response.disposition``) surface how each request was
actually served — the billing attribution at the API boundary:

=================  ========================================================
``LOCAL``          1st-level supervisor trusted the local prediction
``REMOTE``         escalated, served by a remote backend, trusted ($ billed)
``CACHED``         escalated, served from the response cache ($0)
``REJECTED``       escalated but untrusted/failed/policy-rejected → fallback
``DEADLINE_LOCAL`` downgraded to the local prediction: no backend could
                   make the round trip inside ``deadline_s`` (DESIGN.md §8)
``POLICY_LOCAL``   escalation suppressed by policy (``escalation="never"``
                   or ``cost_cap`` below every available backend's price)
``SHED``           refused at admission (DESIGN.md §10): the bounded queue
                   was full, or overload/deadline-infeasibility plus
                   ``on_miss="reject"``; answered immediately from the
                   fallback, never enqueued, $0 billed
=================  ========================================================
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.runtime.cache import RemoteResponseCache
from repro_torch.runtime.controller import AdaptiveController, ControllerConfig
from repro_torch.runtime.transport import (ROUTE_POLICIES, RemoteBackend,
                                     RemoteRouter, TransportConfig)

ESCALATION_MODES = ("auto", "never", "always")
ON_MISS_MODES = ("fallback", "reject")

# Response.disposition values (billing attribution at the API boundary)
LOCAL = "LOCAL"
REMOTE = "REMOTE"
CACHED = "CACHED"
REJECTED = "REJECTED"
DEADLINE_LOCAL = "DEADLINE_LOCAL"
POLICY_LOCAL = "POLICY_LOCAL"
SHED = "SHED"
DISPOSITIONS = (LOCAL, REMOTE, CACHED, REJECTED, DEADLINE_LOCAL,
                POLICY_LOCAL, SHED)

PACKING_MODES = ("none", "policy")

# microbatch formation (DESIGN.md §11): "window" accumulates fixed
# `_next_chunk()` windows (the original behaviour); "continuous" admits
# rows into free slots of a persistent padded batch (slot-map) and hands
# locally-trusted rows back at gate time via in-kernel early emit
BATCHING_MODES = ("window", "continuous")


@dataclass(frozen=True)
class RequestPolicy:
    """Per-request serving contract (DESIGN.md §8).

    ``deadline_s``   — latency SLA measured from enqueue: the engine only
                       escalates when some backend's round-trip estimate
                       (measured EMA/p95, modelled prior until
                       observations arrive) fits in the remaining budget;
                       otherwise the request downgrades to the local
                       prediction (``DEADLINE_LOCAL``) or, with
                       ``on_miss="reject"``, takes the REJECTED path.
    ``cost_cap``     — max $ this request may be billed; backends pricier
                       than the cap are unroutable for it (``cost_cap=0``
                       forces local-only).
    ``routing_hint`` — preferred backend name; advisory — honored when
                       that backend is available and satisfies the
                       window's merged constraints.
    ``escalation``   — ``auto`` (gate decides), ``never`` (stay local even
                       when the gate is untrusted), ``always`` (escalate
                       even when the gate trusts the local answer;
                       deadline/cost feasibility still applies).
    ``on_miss``      — what an infeasible deadline/cost does: ``fallback``
                       serves the local prediction with a ``*_LOCAL``
                       disposition; ``reject`` forces the REJECTED →
                       scheduler-fallback path.

    The all-default policy is semantically identical to *no* policy; the
    engine and scheduler fast-path it so unpolicied traffic stays
    bitwise-identical to the pre-policy runtime.
    """
    deadline_s: float | None = None
    cost_cap: float | None = None
    routing_hint: str | None = None
    escalation: str = "auto"
    on_miss: str = "fallback"

    def __post_init__(self):
        if self.escalation not in ESCALATION_MODES:
            raise ValueError(f"unknown escalation {self.escalation!r}; "
                             f"choose from {ESCALATION_MODES}")
        if self.on_miss not in ON_MISS_MODES:
            raise ValueError(f"unknown on_miss {self.on_miss!r}; "
                             f"choose from {ON_MISS_MODES}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        if self.cost_cap is not None and self.cost_cap < 0:
            raise ValueError("cost_cap must be >= 0")

    @property
    def is_default(self) -> bool:
        """True iff this policy constrains nothing (== no policy)."""
        return (self.deadline_s is None and self.cost_cap is None
                and self.routing_hint is None and self.escalation == "auto")


@dataclass(frozen=True)
class RemoteSpec:
    """Declarative spec for one named remote backend (``ServeConfig``
    builds the actual ``RemoteBackend`` around the deployment's remote
    callable). ``cost_per_request``/``latency_s`` = None fall back to the
    engine's ``CostModel`` constants."""
    name: str
    cost_per_request: float | None = None
    latency_s: float | None = None

    @classmethod
    def parse(cls, spec: str) -> "RemoteSpec":
        """``name[:cost[:latency]]`` — empty fields keep the defaults."""
        parts = spec.split(":")
        if len(parts) > 3 or not parts[0]:
            raise ValueError(f"bad remote spec {spec!r}; "
                             f"expected name[:cost[:latency]]")
        cost = float(parts[1]) if len(parts) > 1 and parts[1] else None
        latency = float(parts[2]) if len(parts) > 2 and parts[2] else None
        return cls(parts[0], cost, latency)


def _parse_remotes(text: str) -> tuple[RemoteSpec, ...]:
    """``name:cost:lat[;name:cost:lat...]`` → tuple of specs."""
    return tuple(RemoteSpec.parse(s) for s in text.split(";") if s)


@dataclass(frozen=True)
class TierSpec:
    """Declarative spec for one hop of an N-tier cascade ladder
    (DESIGN.md §13). The ladder replaces the flat ``remotes`` registry:
    ``ServeConfig.build_router`` chains the tiers into one
    ``CascadeStage`` head routed as a single logical backend — each hop
    answers the rows its supervisor scores above ``threshold`` and
    escalates the residual; the last tier is terminal (its trust gate is
    the engine's ``t_remote``)."""
    name: str
    cost_per_request: float | None = None
    latency_s: float | None = None
    threshold: float = 0.0
    supervisor: str = "max_softmax"

    @classmethod
    def parse(cls, spec: str) -> "TierSpec":
        """``name[:cost[:lat[:threshold[:supervisor]]]]`` — empty fields
        keep the defaults."""
        parts = spec.split(":")
        if len(parts) > 5 or not parts[0]:
            raise ValueError(
                f"bad tier spec {spec!r}; expected "
                f"name[:cost[:latency[:threshold[:supervisor]]]]")
        cost = float(parts[1]) if len(parts) > 1 and parts[1] else None
        latency = float(parts[2]) if len(parts) > 2 and parts[2] else None
        threshold = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
        supervisor = (parts[4] if len(parts) > 4 and parts[4]
                      else "max_softmax")
        return cls(parts[0], cost, latency, threshold, supervisor)


def _parse_tiers(text: str) -> tuple[TierSpec, ...]:
    """``name:cost:lat:thr[;...]`` (outermost hop first) → tier specs."""
    return tuple(TierSpec.parse(s) for s in text.split(";") if s)


@dataclass(frozen=True)
class ServeConfig:
    """The one serving-surface configuration object (DESIGN.md §8).

    ``serve.py`` builds a single ``ServeConfig``; ``CascadeEngine``,
    ``MicrobatchScheduler``, ``RemoteRouter``, the budget controller and
    the response cache are all constructed *from* it (``build_*`` /
    ``from_config``). Field-level overrides parse from ``key=value``
    strings (``with_overrides``), including nested ``transport.*``,
    ``cost.*`` and ``default_policy.*`` fields — the migration target for
    the retired per-knob CLI flags (migration table in DESIGN.md §8).
    """
    # -- cascade --------------------------------------------------------
    batch_size: int = 32
    remote_fraction_budget: float = 0.25
    t_remote: float = 0.9
    t_local: float | None = None
    supervisor: str = "max_softmax"
    cost: Any = None                    # CostModel | None = engine default
    fused: bool = False                 # seed-style fully-jitted cascade
    # -- pipeline / completion (DESIGN.md §5, §7, §11) ------------------
    pipeline_depth: int = 1
    completion_mode: str = "fifo"
    batching: str = "window"            # window | continuous (slot-map)
    # -- remote tier(s) (DESIGN.md §3, §6) ------------------------------
    transport: TransportConfig = field(default_factory=TransportConfig)
    remotes: tuple[RemoteSpec, ...] = ()
    # N-tier cascade ladder (DESIGN.md §13): tiers chain into one routed
    # CascadeStage head (outermost hop first); exclusive with `remotes`
    tiers: tuple[TierSpec, ...] = ()
    route_policy: str = "primary-failover"
    replay_max: int = 8
    # -- response cache (DESIGN.md §4; 0 disables) ----------------------
    cache_size: int = 4096
    # -- budget controller (DESIGN.md §2, §6) ---------------------------
    adaptive: bool = False
    control_window: int = 128
    target_rejection_rate: float = 0.05
    cost_budget: float | None = None    # $/request; None = fraction mode
    # -- per-request policy layer (DESIGN.md §8) ------------------------
    default_policy: RequestPolicy = field(default_factory=RequestPolicy)
    packing: str = "none"               # window packing: none | policy
    # -- overload admission control (DESIGN.md §10; 0 disables) ---------
    # hard queue bound: a request arriving at a full queue is SHED
    # (answered from the fallback, $0, never enqueued). Above
    # ``admission_soft_ratio * admission_limit`` the scheduler applies
    # the request's ``on_miss`` vocabulary instead: ``fallback`` pins
    # the request local (degrade), ``reject`` sheds it.
    admission_limit: int = 0
    admission_soft_ratio: float = 0.5
    # -- observability (DESIGN.md §9) -----------------------------------
    observability: bool = False         # metrics + traces + event log
    trace_capacity: int = 65536         # bounded TraceSink (spans kept)
    event_capacity: int = 8192          # bounded EventLog (events kept)
    # -- cluster scale-out (DESIGN.md §12) ------------------------------
    # replicas > 1 runs N engines behind one logical cascade (shared
    # response cache, shared router, cluster budget reconcile) via
    # ``repro_torch.runtime.cluster.ClusterHarness``; data_parallel splits
    # the local forward's rows over the serving mesh's ``data`` ranks
    # (``launch.mesh.make_serving_mesh``).
    replicas: int = 1
    data_parallel: bool = False

    def __post_init__(self):
        if self.completion_mode not in ("fifo", "streaming"):
            raise ValueError(f"unknown completion_mode "
                             f"{self.completion_mode!r}")
        if self.route_policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown route_policy {self.route_policy!r}; "
                             f"choose from {ROUTE_POLICIES}")
        if self.packing not in PACKING_MODES:
            raise ValueError(f"unknown packing {self.packing!r}; "
                             f"choose from {PACKING_MODES}")
        if self.batching not in BATCHING_MODES:
            raise ValueError(f"unknown batching {self.batching!r}; "
                             f"choose from {BATCHING_MODES}")
        if self.batching == "continuous" and self.completion_mode != \
                "streaming":
            raise ValueError("batching='continuous' requires "
                             "completion_mode='streaming' (rows hand back "
                             "as they clear; a FIFO drain would re-impose "
                             "window quantization)")
        if self.admission_limit < 0:
            raise ValueError("admission_limit must be >= 0")
        if not 0.0 <= self.admission_soft_ratio <= 1.0:
            raise ValueError("admission_soft_ratio must be in [0, 1]")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.tiers and self.remotes:
            raise ValueError("tiers and remotes are exclusive: a tier "
                             "ladder chains into ONE routed backend; mix "
                             "by wrapping backends in CascadeStage "
                             "directly (DESIGN.md §13)")
        if self.replicas > 1 and not self.adaptive:
            raise ValueError("replicas > 1 needs adaptive=True: the "
                             "cluster budget reconcile re-targets each "
                             "replica's controller (DESIGN.md §12)")
        if self.fused and (self.replicas > 1 or self.data_parallel):
            raise ValueError("fused bypasses the runtime path: drop "
                             "replicas/data_parallel")
        if self.fused and (self.adaptive or self.pipeline_depth > 1
                           or self.completion_mode == "streaming"
                           or self.cost_budget is not None
                           or not self.default_policy.is_default
                           or self.packing != "none"
                           or self.remotes
                           or self.tiers
                           or self.observability
                           or self.admission_limit
                           or self.batching != "window"):
            raise ValueError("fused bypasses the transport path: drop "
                             "adaptive/pipeline_depth/streaming/"
                             "cost_budget/default_policy/packing/remotes/"
                             "tiers/observability/admission_limit/"
                             "batching")

    # -- component construction ----------------------------------------
    def build_router(self, remote_apply: Callable, **kw) -> RemoteRouter:
        """Registry of named backends around the deployment's remote
        callable (one ``"remote"`` backend when no specs are given).
        With ``tiers`` set, the specs chain into one ``CascadeStage``
        head routed as a single logical backend (DESIGN.md §13);
        ``remote_apply`` may be a single callable shared by every hop or
        a mapping ``{tier_name: callable}``."""
        if self.tiers:
            from repro_torch.runtime.hierarchy import build_stage_chain
            applies = (remote_apply if isinstance(remote_apply, dict)
                       else {t.name: remote_apply for t in self.tiers})
            head = build_stage_chain(
                [dict(name=t.name, apply=applies[t.name],
                      supervisor=t.supervisor, threshold=t.threshold,
                      cost_per_request=t.cost_per_request,
                      latency_s=t.latency_s) for t in self.tiers],
                config=self.transport, **kw)
            return RemoteRouter([head], policy=self.route_policy,
                                replay_max=self.replay_max)
        specs = self.remotes or (RemoteSpec("remote"),)
        return RemoteRouter(
            [RemoteBackend(s.name, remote_apply, self.transport,
                           cost_per_request=s.cost_per_request,
                           latency_s=s.latency_s, **kw) for s in specs],
            policy=self.route_policy, replay_max=self.replay_max)

    def build_controller(self) -> AdaptiveController | None:
        if not self.adaptive:
            return None
        return AdaptiveController(ControllerConfig(
            target_remote_fraction=self.remote_fraction_budget,
            window=self.control_window,
            target_rejection_rate=self.target_rejection_rate,
            cost_budget_per_request=self.cost_budget))

    def build_observability(self):
        """Fully-enabled ``Observability`` facade (metrics + trace sink +
        event log) sized from the config; None when disabled. The engine
        installs it at construction (``from_config``), which wires the
        router, every backend transport and the controller into the
        shared event log (DESIGN.md §9)."""
        if not self.observability:
            return None
        from repro_torch.runtime.observability import Observability
        return Observability.enabled(trace_capacity=self.trace_capacity,
                                     event_capacity=self.event_capacity)

    def build_cache(self, **kw) -> RemoteResponseCache | None:
        """Response cache sized from the config (``key_fn`` /
        ``key_batch_fn`` pass through); None when disabled."""
        if self.cache_size <= 0:
            return None
        return RemoteResponseCache(self.cache_size, **kw)

    def build_engine(self, local_apply: Callable,
                     remote_apply: Callable | None = None, **kw):
        """``CascadeEngine.from_config`` convenience: on the runtime path
        a ``transport=`` (router) may be passed explicitly, otherwise one
        is built from ``remote_apply`` per the ``remotes`` specs."""
        from repro_torch.serving.engine import CascadeEngine
        return CascadeEngine.from_config(self, local_apply,
                                         remote_apply=remote_apply, **kw)

    def build_scheduler(self, engine, **kw):
        from repro_torch.serving.scheduler import MicrobatchScheduler
        return MicrobatchScheduler.from_config(engine, self, **kw)

    def build(self, local_apply: Callable,
              remote_apply: Callable | None = None, *,
              fallback: Callable | None = None,
              prior: Callable | None = None, **engine_kw):
        """One-call construction of the whole serving stack: returns
        ``(engine, scheduler)`` wired per this config."""
        engine = self.build_engine(local_apply, remote_apply, **engine_kw)
        sched = self.build_scheduler(engine, fallback=fallback, prior=prior)
        return engine, sched

    # -- key=value overrides (the retired flags' migration target) ------
    def with_overrides(self, overrides) -> "ServeConfig":
        """Return a copy with ``key=value`` strings applied. Nested
        ``transport.*`` / ``cost.*`` / ``default_policy.*`` keys reach
        into the sub-configs; ``remotes`` parses a ``name:cost:lat[;...]``
        spec list; ``none`` clears an optional field."""
        updates: dict[str, Any] = {}
        nested: dict[str, dict[str, Any]] = {}
        for item in overrides:
            key, sep, raw = item.partition("=")
            if not sep:
                raise ValueError(f"bad override {item!r}; expected "
                                 f"key=value")
            key = key.strip()
            raw = raw.strip()
            if "." in key:
                outer, inner = key.split(".", 1)
                sub = getattr(self, outer, None)
                if outer not in ("transport", "cost", "default_policy"):
                    raise ValueError(f"unknown nested override {key!r}")
                if outer == "cost" and sub is None:
                    from repro_torch.serving.engine import CostModel
                    sub = CostModel()
                tgt = nested.setdefault(outer, {"_obj": sub})
                tgt[inner] = _coerce_field(type(sub), inner, raw)
            elif key == "remotes":
                # "none" clears the registry (back to the single default
                # "remote" backend), like any other optional field
                updates[key] = (() if raw.lower() in ("none", "null")
                                else _parse_remotes(raw))
            elif key == "tiers":
                updates[key] = (() if raw.lower() in ("none", "null")
                                else _parse_tiers(raw))
            else:
                updates[key] = _coerce_field(ServeConfig, key, raw)
        for outer, kv in nested.items():
            obj = kv.pop("_obj")
            updates[outer] = dataclasses.replace(obj, **kv)
        return dataclasses.replace(self, **updates)


def _coerce_field(cls, name: str, raw: str) -> Any:
    """Parse ``raw`` per the declared type of dataclass field ``name``."""
    flds = {f.name: f for f in dataclasses.fields(cls)}
    if name not in flds:
        raise ValueError(f"unknown {cls.__name__} field {name!r}; "
                         f"known: {sorted(flds)}")
    if raw.lower() in ("none", "null"):
        return None
    ann = str(flds[name].type)
    if "bool" in ann:
        if raw.lower() in ("true", "1", "yes", "on"):
            return True
        if raw.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"bad bool for {name}: {raw!r}")
    if "int" in ann:
        return int(raw)
    if "float" in ann:
        return float(raw)
    if "str" in ann:
        return raw
    # non-scalar field (cost/transport/default_policy): storing the raw
    # string would blow up far from the CLI — demand nested overrides
    raise ValueError(f"{cls.__name__}.{name} is not settable as a bare "
                     f"value; use nested '{name}.<field>=...' overrides")
