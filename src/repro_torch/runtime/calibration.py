"""Offline cascade calibration: cost-vs-accuracy Pareto sweeps
(runtime control plane, DESIGN.md §1).

Given a labelled validation set scored by both tiers — 1st-level
supervisor confidences + correctness for the local model, 2nd-level
confidences + correctness for the remote model — sweep the
``(t_local, t_remote)`` grid with exact Algorithm-1 semantics
(``core.cascade.bisupervised_batch``, paper RQ1/RQ2 style), build the
Pareto frontier over (remote fraction, accepted accuracy, rejection rate),
and select the operating point for a target remote-call budget. The
selected point is returned with the serving-mode capacity
``k = ceil(rho * B)`` so it can be handed straight to the engine, and is
also the recommended warm start for the online ``AdaptiveController``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.cascade import escalation_capacity


@dataclass(frozen=True)
class OperatingPoint:
    t_local: float
    t_remote: float
    remote_fraction: float    # realised escalation rate on the val set
    rejection_rate: float     # REJECTED fraction (fallback path)
    accuracy: float           # accuracy over accepted inputs
    system_accuracy: float    # accuracy over ALL inputs (rejected = wrong)
    cost_per_request: float

    def capacity(self, batch_size: int) -> int:
        """Serving-mode escalation cap for this point (DESIGN.md §2)."""
        return escalation_capacity(batch_size, max(self.remote_fraction,
                                                   1e-6))


def _quantile_grid(values: np.ndarray, n: int) -> np.ndarray:
    """Candidate thresholds at n evenly spaced quantiles, plus the open
    ends (never/always escalate or reject)."""
    v = np.asarray(values, np.float64)
    qs = np.quantile(v, np.linspace(0.0, 1.0, n))
    return np.unique(np.concatenate(
        [[v.min() - 1e-9], qs, [v.max() + 1e-9]]))


def sweep_operating_points(local_conf: np.ndarray, local_correct: np.ndarray,
                           remote_conf: np.ndarray, remote_correct: np.ndarray,
                           *, grid: int = 33,
                           remote_cost_per_request: float = 0.0048
                           ) -> list[OperatingPoint]:
    """Exhaustive (t_local, t_remote) sweep with Algorithm-1 semantics.

    All arrays are [n] over the validation set; correctness is 0/1.
    Vectorised: for each t_local the escalated set is fixed, and every
    t_remote candidate only re-partitions it into REMOTE vs REJECTED.
    """
    lc = np.asarray(local_conf, np.float64)
    lok = np.asarray(local_correct, bool)
    rc = np.asarray(remote_conf, np.float64)
    rok = np.asarray(remote_correct, bool)
    n = lc.shape[0]

    points: list[OperatingPoint] = []
    for tl in _quantile_grid(lc, grid):
        use_local = lc > tl
        esc = ~use_local
        n_esc = int(esc.sum())
        local_hits = int(lok[use_local].sum())
        for tr in _quantile_grid(rc[esc] if n_esc else rc, grid):
            remote_ok = esc & (rc > tr)
            accepted = use_local | remote_ok
            n_acc = int(accepted.sum())
            hits = local_hits + int(rok[remote_ok].sum())
            points.append(OperatingPoint(
                t_local=float(tl), t_remote=float(tr),
                remote_fraction=n_esc / n,
                rejection_rate=1.0 - n_acc / n,
                accuracy=hits / max(n_acc, 1),
                system_accuracy=hits / n,
                cost_per_request=n_esc / n * remote_cost_per_request))
    return points


def pareto_frontier(points: Sequence[OperatingPoint]
                    ) -> list[OperatingPoint]:
    """Non-dominated subset: maximise accepted accuracy, minimise remote
    fraction and rejection rate. Sorted by ascending remote fraction."""
    # distinct threshold pairs can land on identical metrics; keep one
    seen: set[tuple] = set()
    pts = []
    for p in sorted(points, key=lambda p: (p.remote_fraction,
                                           p.rejection_rate, -p.accuracy)):
        m = (p.remote_fraction, p.rejection_rate, p.accuracy)
        if m not in seen:
            seen.add(m)
            pts.append(p)
    front: list[OperatingPoint] = []
    for p in pts:
        dominated = any(q.accuracy >= p.accuracy
                        and q.remote_fraction <= p.remote_fraction
                        and q.rejection_rate <= p.rejection_rate
                        and (q.accuracy > p.accuracy
                             or q.remote_fraction < p.remote_fraction
                             or q.rejection_rate < p.rejection_rate)
                        for q in pts)
        if not dominated:
            front.append(p)
    return front


def select_operating_point(points: Sequence[OperatingPoint],
                           budget: float | None = None, *,
                           cost_budget: float | None = None,
                           max_rejection_rate: float | None = None
                           ) -> OperatingPoint:
    """Best accepted accuracy subject to a budget (and an optional
    rejection-rate ceiling); ties broken toward cheaper points. The budget
    is either a remote *fraction* (``budget``) or a **dollar** ceiling on
    modelled $ per request (``cost_budget`` — per-backend pricing enters
    via ``remote_cost_per_request`` at sweep time, e.g. the router's
    ``expected_cost_per_escalation``). Falls back to the cheapest point if
    the budget excludes everything."""
    if (budget is None) == (cost_budget is None):
        raise ValueError("give exactly one of budget / cost_budget")
    if cost_budget is not None:
        feasible = [p for p in points
                    if p.cost_per_request <= cost_budget + 1e-12]
    else:
        feasible = [p for p in points if p.remote_fraction <= budget + 1e-12]
    if max_rejection_rate is not None:
        hard = [p for p in feasible
                if p.rejection_rate <= max_rejection_rate + 1e-12]
        feasible = hard or feasible
    if not feasible:
        feasible = [min(points, key=lambda p: p.remote_fraction)]
    return max(feasible, key=lambda p: (p.accuracy, -p.remote_fraction,
                                        -p.rejection_rate))


# ---------------------------------------------------------------------------
# Joint (t_1, ..., t_n) calibration for N-tier hierarchies (DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JointOperatingPoint:
    """One point on the joint (t_1, ..., t_n) operating surface of an
    N-tier cascade. ``stage_fractions[i]`` is the fraction of rows that
    *reach* stage i (``[0] == 1.0``); ``cost_per_request`` prices each
    reach at that stage's per-row cost. The 2-stage case carries exactly
    the ``OperatingPoint`` metrics (the exact-reproduction property the
    tests pin down)."""
    thresholds: tuple
    stage_fractions: tuple
    rejection_rate: float
    accuracy: float           # accuracy over accepted inputs
    system_accuracy: float    # accuracy over ALL inputs (rejected = wrong)
    cost_per_request: float

    @property
    def remote_fraction(self) -> float:
        """Fraction leaving the device tier (2-tier compatibility)."""
        return self.stage_fractions[1] if len(self.stage_fractions) > 1 \
            else 0.0

    def capacity(self, batch_size: int) -> int:
        return escalation_capacity(batch_size, max(self.remote_fraction,
                                                   1e-6))


def _stage_grids(grid, n_stages: int) -> list[int]:
    if isinstance(grid, int):
        return [grid] * n_stages
    grids = list(grid)
    if len(grids) != n_stages:
        raise ValueError(f"grid must be an int or one per stage "
                         f"({n_stages}), got {len(grids)}")
    return grids


def sweep_joint_operating_points(confs, corrects, *, grid=17,
                                 stage_costs=None, prune: bool = True
                                 ) -> list[JointOperatingPoint]:
    """Exhaustive sweep of the joint (t_1, ..., t_n) threshold surface.

    ``confs``/``corrects`` are n_stages row-aligned arrays over the
    validation set: stage i's supervisor confidence and 0/1 correctness
    for every row *as if* it reached stage i. ``stage_costs[i]`` is the
    per-row price of reaching stage i (``[0]`` is the device tier,
    conventionally 0). Semantics per stage mirror the 2-level sweep
    exactly — strict ``>`` comparisons, quantile grids conditioned on
    the rows actually reaching the stage — so with ``n_stages == 2``
    this reproduces ``sweep_operating_points`` point for point (tested).

    ``grid`` is an int (same per stage) or one int per stage. With
    ``prune=True`` an *intermediate* stage that nothing reaches stops
    branching (every deeper threshold choice is metrically identical);
    the final stage always enumerates its full grid, matching the
    2-level sweep's behaviour on empty escalation sets.
    """
    confs = [np.asarray(c, np.float64) for c in confs]
    oks = [np.asarray(c, bool) for c in corrects]
    n_stages = len(confs)
    if n_stages < 2:
        raise ValueError("need at least 2 stages")
    if len(oks) != n_stages:
        raise ValueError("confs and corrects must align per stage")
    n = confs[0].shape[0]
    grids = _stage_grids(grid, n_stages)
    if stage_costs is None:
        stage_costs = [0.0] * (n_stages - 1) + [0.0048]
    stage_costs = [float(c) for c in stage_costs]
    if len(stage_costs) != n_stages:
        raise ValueError("stage_costs must give one price per stage")

    points: list[JointOperatingPoint] = []

    def rec(i, reach, thresholds, fracs, hits, answered_count, cost):
        ci = confs[i]
        n_reach = int(reach.sum())
        cand = _quantile_grid(ci[reach] if n_reach else ci, grids[i])
        if i == n_stages - 1:
            for t in cand:
                ok_rows = reach & (ci > t)
                n_acc = answered_count + int(ok_rows.sum())
                h = hits + int(oks[i][ok_rows].sum())
                points.append(JointOperatingPoint(
                    thresholds=(*thresholds, float(t)),
                    stage_fractions=(*fracs,),
                    rejection_rate=1.0 - n_acc / n,
                    accuracy=h / max(n_acc, 1),
                    system_accuracy=h / n,
                    cost_per_request=cost))
            return
        if prune and n_reach == 0 and i > 0:
            cand = cand[:1]        # every branch below is identical
        for t in cand:
            ans = reach & (ci > t)
            resid = reach & ~ans
            n_resid = int(resid.sum())
            rec(i + 1, resid, (*thresholds, float(t)),
                (*fracs, n_resid / n),
                hits + int(oks[i][ans].sum()),
                answered_count + int(ans.sum()),
                cost + n_resid / n * stage_costs[i + 1])
        return

    rec(0, np.ones(n, bool), (), (1.0,), 0, 0, 0.0)
    return points


def joint_pareto_frontier(points: "Sequence[JointOperatingPoint]"
                          ) -> list[JointOperatingPoint]:
    """Non-dominated subset over ($/request, system accuracy), sorted by
    ascending cost. System accuracy folds the rejection rate in (a
    rejected row is a wrong row), so the frontier is strictly monotone:
    each successive point costs strictly more and answers strictly more
    of the workload correctly."""
    front: list[JointOperatingPoint] = []
    best = -1.0
    for p in sorted(points, key=lambda p: (p.cost_per_request,
                                           -p.system_accuracy,
                                           p.rejection_rate)):
        if p.system_accuracy > best:
            best = p.system_accuracy
            front.append(p)
    return front


def select_joint_operating_point(points, *, budget: float | None = None,
                                 cost_budget: float | None = None,
                                 max_rejection_rate: float | None = None
                                 ) -> JointOperatingPoint:
    """Best system accuracy under a budget: either a fraction budget on
    rows leaving the device tier (``budget``) or a dollar ceiling on the
    per-stage-priced $/request (``cost_budget``). Mirrors
    ``select_operating_point``: the rejection ceiling is soft, and an
    infeasible budget falls back to the cheapest point."""
    if (budget is None) == (cost_budget is None):
        raise ValueError("give exactly one of budget / cost_budget")
    if cost_budget is not None:
        feasible = [p for p in points
                    if p.cost_per_request <= cost_budget + 1e-12]
    else:
        feasible = [p for p in points
                    if p.remote_fraction <= budget + 1e-12]
    if max_rejection_rate is not None:
        hard = [p for p in feasible
                if p.rejection_rate <= max_rejection_rate + 1e-12]
        feasible = hard or feasible
    if not feasible:
        feasible = [min(points, key=lambda p: p.cost_per_request)]
    return max(feasible, key=lambda p: (p.system_accuracy,
                                        -p.cost_per_request,
                                        -p.rejection_rate))


class EscalationPrior:
    """P(escalate | proxy score): the calibration-table prior behind the
    scheduler's policy-aware window packing (DESIGN.md §8).

    Fit from calibration-time pairs of a *request-observable* proxy score
    (anything cheap the caller can compute before the local forward — a
    feature margin, input length, a stale cached confidence; the 1st-level
    supervisor confidence itself when scoring offline) and the escalation
    outcome under the selected ``t_local``. Scores are bucketed at
    quantile edges; calling the prior with a new proxy score returns the
    bucket's empirical escalation rate. Monotone inputs give a monotone
    table, but nothing requires the proxy to be the confidence itself.
    """

    def __init__(self, edges: np.ndarray, rates: np.ndarray):
        self.edges = np.asarray(edges, np.float64)      # [bins+1]
        self.rates = np.asarray(rates, np.float64)      # [bins]

    def __call__(self, score: float) -> float:
        i = int(np.searchsorted(self.edges, score, side="right")) - 1
        return float(self.rates[np.clip(i, 0, self.rates.size - 1)])

    def batch(self, scores: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.edges, np.asarray(scores, np.float64),
                              side="right") - 1
        return self.rates[np.clip(idx, 0, self.rates.size - 1)]


def fit_escalation_prior(proxy_scores: np.ndarray,
                         escalated: np.ndarray, *,
                         bins: int = 16) -> EscalationPrior:
    """Bucket ``proxy_scores`` at quantile edges and record each bucket's
    empirical escalation rate. ``escalated`` is the 0/1 outcome under the
    chosen operating point (e.g. ``local_conf <= t_local``). Empty
    buckets inherit the global rate."""
    s = np.asarray(proxy_scores, np.float64).ravel()
    e = np.asarray(escalated, bool).ravel()
    if s.size != e.size or s.size == 0:
        raise ValueError("need matching, non-empty proxy/escalated arrays")
    edges = np.unique(np.quantile(s, np.linspace(0.0, 1.0, bins + 1)))
    if edges.size < 2:                      # constant proxy: one bucket
        edges = np.array([s[0] - 1e-9, s[0] + 1e-9])
    idx = np.clip(np.searchsorted(edges, s, side="right") - 1,
                  0, edges.size - 2)
    rates = np.full(edges.size - 1, float(e.mean()))
    for b in range(edges.size - 1):
        m = idx == b
        if m.any():
            rates[b] = float(e[m].mean())
    return EscalationPrior(edges, rates)


def calibrate(local_conf, local_correct, remote_conf, remote_correct, *,
              budget: float | None = None, batch_size: int, grid: int = 33,
              cost_budget: float | None = None,
              max_rejection_rate: float | None = None,
              remote_cost_per_request: float = 0.0048
              ) -> tuple[OperatingPoint, int, list[OperatingPoint]]:
    """One-call calibration: sweep, take the frontier, pick the budget
    point — a remote-fraction ``budget`` or a dollar ``cost_budget``
    (price escalations with the deployment's real per-call cost, e.g.
    ``router.expected_cost_per_escalation``). Returns (point, capacity k
    for ``batch_size``, frontier)."""
    pts = sweep_operating_points(
        local_conf, local_correct, remote_conf, remote_correct,
        grid=grid, remote_cost_per_request=remote_cost_per_request)
    front = pareto_frontier(pts)
    best = select_operating_point(front, budget, cost_budget=cost_budget,
                                  max_rejection_rate=max_rejection_rate)
    return best, best.capacity(batch_size), front
