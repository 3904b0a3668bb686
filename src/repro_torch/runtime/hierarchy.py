"""N-tier cascade hierarchy: device → edge → cloud stages (DESIGN.md §13).

The paper's BiSupervised architecture is a two-level cascade — one local
model behind a 1st-level supervisor, one remote behind a 2nd. The DDNN
line of work (Teerapittayanon et al., PAPERS.md) generalizes exactly this
shape into a *hierarchy* of exit points: a cheap tier answers the rows
its supervisor trusts and escalates the residual to the next tier, each
hop with its own supervisor/threshold pair, until the last hop — whose
supervisor is the paper's 2nd-level supervisor, deciding trust vs the
raise-exception/fallback path.

``CascadeStage`` is a ``RemoteBackend`` that is itself a supervised
predictor: it wraps a model-apply (through its own ``RemoteTransport`` —
retries, breaker, billing) or an existing backend's transport, owns a
supervisor score function from ``core.supervisors``, a threshold, and an
optional ``next_stage`` reference. Because it *is* a backend, the
existing ``RemoteRouter``/``CascadeEngine`` machinery routes to it
unchanged; because it may chain, a single routed "backend" can hide an
arbitrary device→edge→cloud ladder behind the engine's 2-level shape.

The bitwise 2-tier identity argument: a **terminal** stage (no
``next_stage``) never intercepts anything — ``call``/``submit`` delegate
straight to ``RemoteBackend`` and ``take_detail`` returns ``None`` — so
an engine routed at a terminal stage executes byte-for-byte the code
path it executes for a plain backend. Only a *chained* stage produces a
per-call ``StageDetail`` (which hop answered each row, at what
confidence, billed what), and only then does the engine switch to
per-stage attribution. The degenerate 2-stage configuration therefore
reproduces today's engine path exactly (predictions, billing, controller
observations) — the property ``hierarchy_bench`` gates in CI.

``TieredCascade`` drives a full stage chain standalone (calibration,
benches, and the collapse/property tests): stage 0 is the device tier,
the last stage's threshold is applied as the trust-vs-REJECTED gate.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.supervisors import SOFTMAX_SUPERVISORS
from repro_torch.tree import tree_leaves, tree_map

from .cache import to_host
from .transport import RemoteBackend, TransportConfig

__all__ = [
    "CascadeStage",
    "StageStats",
    "TieredCascade",
    "build_stage_chain",
]


@dataclass
class StageStats:
    """Per-stage slice of the hierarchy accounting, over rows that
    *reached* the stage. ``requests = answered + escalated + failures``
    and ``cost`` bills every row the hop's own transport served —
    answered *or* escalated — matching the joint-calibration cost model
    (`TransportStats` on the stage's own transport still counts
    windows/retries underneath)."""
    requests: int = 0       # rows that reached this stage
    answered: int = 0       # rows this stage's supervisor trusted
    escalated: int = 0      # rows handed to the next hop
    failures: int = 0       # rows lost here with no next hop to try
    cost: float = 0.0       # realised $ for rows this hop's model served


def _tree_rows(batch: Any) -> int:
    return tree_leaves(batch)[0].shape[0]


def _take(a: Any, mask_or_idx: np.ndarray) -> Any:
    if isinstance(a, torch.Tensor):
        # a device tensor is gathered where it lies
        return a[torch.as_tensor(mask_or_idx, device=a.device)]
    return np.asarray(a)[mask_or_idx]


def _tree_take(batch: Any, mask_or_idx: np.ndarray) -> Any:
    return tree_map(lambda a: _take(a, mask_or_idx), batch)


def _resolve_supervisor(supervisor) -> Callable:
    return (supervisor if callable(supervisor)
            else SOFTMAX_SUPERVISORS[supervisor])


class CascadeStage(RemoteBackend):
    """One hop of an N-tier cascade, presented as a ``RemoteBackend``.

    Construct around a model-apply (it gets its own transport — per-hop
    retries, breaker, stats) or around an existing ``RemoteBackend``
    (``backend=...`` — the stage shares its transport, so breaker state
    and ``TransportStats`` stay one per physical tier)::

        cloud = CascadeStage("cloud", cloud_apply, threshold=0.9,
                             cost_per_request=0.0048)
        edge  = CascadeStage("edge", edge_apply, threshold=0.7,
                             cost_per_request=0.001, next_stage=cloud)

    ``threshold`` gates this stage's own answers when the stage is *not*
    the last word: a chained stage answers the rows its supervisor
    scores above the threshold and escalates the rest. A terminal stage
    (``next_stage=None``) applies NO gate of its own inside the engine —
    the engine's 2nd-level supervisor (``t_remote``) is the trust gate
    for whatever comes back, which is exactly what keeps the degenerate
    2-stage configuration bitwise-identical to a plain backend. Driven
    standalone through ``TieredCascade``, the last stage's threshold is
    applied by the cascade as the trust-vs-REJECTED gate.

    An optional per-hop ``controller`` (an ``AdaptiveController``) makes
    the threshold live: when attached and warmed up, its ``t_local``
    replaces the static threshold and every chained call feeds it one
    observation — the per-tier budget loop of
    ``controller.TieredBudgetController``.
    """

    def __init__(self, name: str, apply_fn: Callable | None = None,
                 config: TransportConfig = TransportConfig(), *,
                 backend: RemoteBackend | None = None,
                 supervisor="max_softmax", threshold: float = 0.0,
                 next_stage: "CascadeStage | None" = None,
                 cost_per_request: float | None = None,
                 latency_s: float | None = None,
                 controller=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if next_stage is not None and not isinstance(next_stage,
                                                     CascadeStage):
            raise TypeError("next_stage must be a CascadeStage (wrap "
                            "plain backends so every hop has a "
                            "supervisor)")
        if backend is not None:
            if cost_per_request is None:
                cost_per_request = backend.cost_per_request
            if latency_s is None:
                latency_s = backend.latency_s
            super().__init__(name, transport=backend.transport,
                             cost_per_request=cost_per_request,
                             latency_s=latency_s)
        else:
            super().__init__(name, apply_fn, config,
                             cost_per_request=cost_per_request,
                             latency_s=latency_s, clock=clock, sleep=sleep)
        self.supervisor = supervisor
        self._score = _resolve_supervisor(supervisor)
        self.threshold = float(threshold)
        self.next = next_stage
        self.controller = controller
        self.stage_stats = StageStats()
        self._stage_lock = threading.Lock()
        self._details: dict[Any, dict] = {}
        self._chain_pool: ThreadPoolExecutor | None = None

    # -- per-call detail handoff (engine integration) -------------------
    def take_detail(self, tag) -> dict | None:
        """Pop the per-row stage attribution recorded by the last chained
        ``call`` under ``tag``. ``None`` for terminal stages (which never
        record one) — the engine's signal to stay on the plain-backend
        accounting path."""
        with self._stage_lock:
            return self._details.pop(tag, None)

    # -- chain walk -----------------------------------------------------
    def effective_threshold(self) -> float:
        if self.controller is not None and self.controller.t_local is not None:
            return float(self.controller.t_local)
        return self.threshold

    def score_rows(self, logits: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Supervisor confidence per row; failed rows score -inf (a lost
        row can never be trusted — Algorithm 1's exception path)."""
        conf = np.full(len(ok), -np.inf, np.float64)
        if ok.any():
            # scored in float32 on the host, as the reference scores the
            # rows it gets back
            rows = np.asarray(to_host(logits)[ok], np.float32)
            conf[ok] = to_host(self._score(torch.from_numpy(rows))
                               ).astype(np.float64)
        return conf

    def call_scored(self, batch: Any, tag=None
                    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Run the chain from this hop down and return
        ``(logits, ok, detail)`` where ``detail`` carries, per row: the
        answering stage's name, its supervisor confidence, and the row's
        cumulative price/latency over every hop that served it (``nan``
        = some serving hop is unpriced -> resolve the row to the
        engine's ``CostModel`` default). Rows failed at every reachable
        hop come back ``ok=False`` with the deepest attempted stage's
        name."""
        n = _tree_rows(batch)
        logits, ok = RemoteBackend.call(self, batch, tag)
        logits = to_host(logits)
        ok = np.asarray(ok, bool)
        conf = self.score_rows(logits, ok)
        detail = {
            "stage": np.full(n, self.name, object),
            "conf": conf.copy(),
            "cost": np.full(n, np.nan if self.cost_per_request is None
                            else float(self.cost_per_request), np.float64),
            "latency": np.full(n, np.nan if self.latency_s is None
                               else float(self.latency_s), np.float64),
        }
        if self.next is None:
            self._record(n, answered=int(ok.sum()),
                         escalated=0, failures=int((~ok).sum()),
                         served=int(ok.sum()))
            self._observe(conf, escalated=0, requests=n)
            return logits, ok, detail

        threshold = self.effective_threshold()
        trusted = ok & (conf > threshold)
        resid = ~trusted
        n_resid = int(resid.sum())
        self._record(n, answered=n - n_resid, escalated=n_resid,
                     failures=0, served=int(ok.sum()))
        self._observe(conf, escalated=n_resid, requests=n)
        if n_resid:
            sub = _tree_take(batch, resid)
            nl, nok, ndet = self.next.call_scored(sub, tag)
            idx = np.flatnonzero(resid)
            if nl.shape[1:] != logits.shape[1:]:
                raise ValueError(
                    f"stage {self.next.name!r} logits shape {nl.shape[1:]}"
                    f" != stage {self.name!r} {logits.shape[1:]} — tiers "
                    "must share one label space")
            # rows this hop's own transport served before escalating keep
            # paying this hop on top of whatever deeper hops bill — the
            # runtime analogue of the joint-calibration cost model, where
            # every stage a row *reaches* charges its stage cost. An
            # unpriced hop (cost_per_request=None) poisons the sum to
            # nan, which the engine resolves to its CostModel default.
            served_here = ok[idx]
            own_c = (np.nan if self.cost_per_request is None
                     else float(self.cost_per_request))
            own_l = (np.nan if self.latency_s is None
                     else float(self.latency_s))
            logits = logits.copy()
            logits[idx] = nl
            ok = trusted.copy()
            ok[idx] = nok
            detail["stage"][idx] = ndet["stage"]
            detail["conf"][idx] = ndet["conf"]
            detail["cost"][idx] = (ndet["cost"]
                                   + np.where(served_here, own_c, 0.0))
            detail["latency"][idx] = (ndet["latency"]
                                      + np.where(served_here, own_l, 0.0))
        else:
            ok = trusted
        return logits, ok, detail

    # -- RemoteBackend surface ------------------------------------------
    def call(self, batch: Any, tag=None):
        if self.next is None:
            # terminal: pure delegation — the degenerate 2-stage config
            # executes the plain-backend path byte for byte
            return RemoteBackend.call(self, batch, tag)
        logits, ok, detail = self.call_scored(batch, tag)
        with self._stage_lock:
            self._details[tag] = detail
        return logits, ok

    def submit(self, batch: Any, tag=None):
        if self.next is None:
            return RemoteBackend.submit(self, batch, tag)
        # the chain walk (own hop -> supervisor -> residual downstream)
        # runs on a stage-owned pool thread; per-hop transport semantics
        # are untouched because the walk goes through each hop's own
        # call(). concurrent.futures.Future already speaks the
        # TransportFuture drain API (done/result/add_done_callback).
        if self._chain_pool is None:
            self._chain_pool = ThreadPoolExecutor(
                max_workers=self.config.max_concurrent,
                thread_name_prefix=f"stage-{self.name}")
        return self._chain_pool.submit(self.call, batch, tag)

    def poll(self, future) -> bool:
        return future.done()

    def shutdown(self, wait: bool = True) -> None:
        if self._chain_pool is not None:
            self._chain_pool.shutdown(wait=wait)
            self._chain_pool = None
        RemoteBackend.shutdown(self, wait=wait)
        if self.next is not None:
            self.next.shutdown(wait=wait)

    # -- internal -------------------------------------------------------
    def _record(self, requests, *, answered, escalated, failures,
                served) -> None:
        with self._stage_lock:
            st = self.stage_stats
            st.requests += requests
            st.answered += answered
            st.escalated += escalated
            st.failures += failures
            if self.cost_per_request is not None:
                st.cost += served * self.cost_per_request

    def _observe(self, conf, *, escalated: int, requests: int) -> None:
        if self.controller is not None:
            self.controller.observe(conf, escalated, requests)

    def chain(self) -> "list[CascadeStage]":
        """This stage and everything below it, outermost first."""
        out, s = [], self
        while s is not None:
            out.append(s)
            s = s.next
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        nxt = self.next.name if self.next is not None else None
        return (f"CascadeStage({self.name!r}, threshold={self.threshold},"
                f" cost={self.cost_per_request}, next={nxt!r})")


def build_stage_chain(specs, *, clock=time.monotonic, sleep=time.sleep,
                      config: TransportConfig = TransportConfig()
                      ) -> CascadeStage:
    """Chain stage specs (outermost first) into one routed backend.

    Each spec is a mapping with ``name`` and ``apply`` (or ``backend``),
    plus optional ``supervisor``/``threshold``/``cost_per_request``/
    ``latency_s``/``config``. Returns the head stage."""
    if not specs:
        raise ValueError("need at least one stage spec")
    head: CascadeStage | None = None
    for spec in reversed(list(specs)):
        spec = dict(spec)
        name = spec.pop("name")
        apply_fn = spec.pop("apply", None)
        backend = spec.pop("backend", None)
        head = CascadeStage(name, apply_fn,
                            spec.pop("config", config),
                            backend=backend,
                            supervisor=spec.pop("supervisor",
                                                "max_softmax"),
                            threshold=spec.pop("threshold", 0.0),
                            cost_per_request=spec.pop("cost_per_request",
                                                      None),
                            latency_s=spec.pop("latency_s", None),
                            controller=spec.pop("controller", None),
                            next_stage=head, clock=clock, sleep=sleep)
        if spec:
            raise ValueError(f"unknown stage spec keys {sorted(spec)}")
    return head


@dataclass
class TieredResult:
    """Standalone cascade output for one batch (row-aligned arrays)."""
    prediction: np.ndarray      # final argmax (answering stage's logits)
    stage: np.ndarray           # answering stage name per row (object)
    conf: np.ndarray            # answering stage's supervisor confidence
    accepted: np.ndarray        # False = REJECTED -> fallback (last gate)
    cost: np.ndarray            # realised $ per row
    stage_index: np.ndarray     # answering stage's position in the chain


class TieredCascade:
    """An ordered device → edge → cloud chain driven standalone.

    Wraps a ``CascadeStage`` head (stage 0 is the *device* tier — in the
    engine path that tier is the engine's local model, here it is an
    explicit stage) and applies the last stage's threshold as the
    trust-vs-REJECTED gate, i.e. the paper's 2nd-level supervisor. With
    every non-final threshold at ``+inf`` the cascade degenerates to
    always-escalate: each hop trusts nothing and the last stage answers
    everything (the collapse property the tests pin down).
    """

    def __init__(self, head: CascadeStage, *, default_cost: float = 0.0):
        self.head = head
        self.stages = head.chain()
        self.default_cost = float(default_cost)
        self._tag = 0

    @property
    def last(self) -> CascadeStage:
        return self.stages[-1]

    def serve(self, batch: Any) -> TieredResult:
        self._tag += 1
        logits, ok, detail = self.head.call_scored(batch, self._tag)
        pred = np.argmax(to_host(logits), -1)     # first index on ties
        names = [s.name for s in self.stages]
        index = {n: i for i, n in enumerate(names)}
        stage_idx = np.array([index[s] for s in detail["stage"]], np.int64)
        last_rows = detail["stage"] == self.last.name
        gate = self.last.effective_threshold()
        accepted = ok & (~last_rows | (detail["conf"] > gate))
        cost = np.where(np.isnan(detail["cost"]), self.default_cost,
                        detail["cost"])
        cost = np.where(accepted | last_rows, cost, 0.0)
        cost[~ok] = 0.0                       # lost rows bill nothing
        return TieredResult(prediction=pred, stage=detail["stage"],
                            conf=detail["conf"], accepted=accepted,
                            cost=cost, stage_index=stage_idx)

    __call__ = serve

    def stats(self) -> dict[str, StageStats]:
        return {s.name: s.stage_stats for s in self.stages}

    def shutdown(self, wait: bool = True) -> None:
        self.head.shutdown(wait=wait)
