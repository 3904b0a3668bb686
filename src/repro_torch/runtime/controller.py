"""Online budget controller for the cascade (runtime control plane,
DESIGN.md §2).

The paper (§4.5) calls thresholds *runtime-tunable configuration* but the
seed engine froze ``t_remote`` and the escalation capacity at construction.
This controller closes the loop: it tracks the realised remote fraction
against a budget and retunes, once per control window,

  * ``t_local``   — quantile tracking on a rolling buffer of 1st-level
    supervisor scores, feed-forward corrected by a PI term on the EMA of
    the budget error (classic EMA/PID hybrid: the quantile adapts to the
    score distribution, the PI term absorbs cap saturation and mix shift);
  * ``capacity``  — the per-batch escalation cap k, kept at
    ``ceil(min(1, slack * rho) * B)`` so bursts cannot blow the budget;
  * ``t_remote``  — quantile of recently observed 2nd-level scores at the
    target rejection (false-alarm) rate, mirroring the nominal-quantile
    calibration of ``core.thresholds`` but online.

Drift detection: the controller keeps a reference histogram of 1st-level
scores and compares each window's histogram via the Population Stability
Index. On PSI > ``drift_threshold`` it declares a drift event, drops the
PI integral (stale under the new distribution), rebases the reference and
recalibrates ``t_local`` directly from the drifted window.

Until the first window completes the controller reports ``t_local = None``
and the engine falls back to budget-exact capacity-k selection (the seed
behaviour) — a safe warm start.

Dollar budgets (DESIGN.md §6): with a multi-remote registry the price of
an escalation depends on which backend served it, so a remote-*fraction*
budget no longer pins spend. When ``cost_budget_per_request`` is set the
controller learns the realised blended $ per escalation (EMA over windows
of the per-window billed cost the engine reports via ``observe(cost=...)``)
and re-derives the effective target fraction each window as
``cost_budget / ema_cost_per_escalation`` — the existing fraction loop then
holds a **dollar** budget across failovers and price mixes.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.cascade import escalation_capacity


@dataclass(frozen=True)
class ControllerConfig:
    target_remote_fraction: float = 0.2
    window: int = 256             # requests per control update
    ema_alpha: float = 0.4        # EMA weight of the newest window
    kp: float = 0.8               # proportional gain on budget error
    ki: float = 0.3               # integral gain
    integral_clip: float = 0.25
    history: int = 4096           # rolling score-buffer length
    drift_bins: int = 16
    drift_threshold: float = 0.25  # PSI above this = drift event
    capacity_slack: float = 2.0   # per-batch cap = slack * rho * B
    target_rejection_rate: float = 0.05  # 2nd-level nominal false-alarm
    # dollar budget: target realised $ per request; None = fraction mode.
    # The effective target fraction becomes cost_budget / learned blended
    # $-per-escalation, clipped to [0, target_remote_fraction ceiling 1].
    cost_budget_per_request: float | None = None
    cost_ema_alpha: float = 0.3   # EMA weight for $-per-escalation


@dataclass
class ControllerState:
    t_local: float | None = None
    t_remote: float | None = None
    rho: float = 0.0              # current feed-forward escalation rate
    ema_fraction: float = 0.0
    integral: float = 0.0
    windows: int = 0
    drift_events: int = 0
    last_psi: float = 0.0
    # dollar-budget telemetry (None until the first costed window)
    ema_cost_per_escalation: float | None = None
    effective_target: float | None = None


def population_stability_index(p_counts: np.ndarray,
                               q_counts: np.ndarray) -> float:
    """PSI between two histograms (same binning); symmetric-ish drift score."""
    p = p_counts / max(p_counts.sum(), 1)
    q = q_counts / max(q_counts.sum(), 1)
    eps = 1e-4
    p, q = np.clip(p, eps, None), np.clip(q, eps, None)
    p, q = p / p.sum(), q / q.sum()
    return float(np.sum((p - q) * np.log(p / q)))


class AdaptiveController:
    """EMA/PI budget controller with histogram drift detection."""

    def __init__(self, config: ControllerConfig = ControllerConfig()):
        self.config = config
        self.state = ControllerState(rho=config.target_remote_fraction)
        self._scores: deque[float] = deque(maxlen=config.history)
        self._remote_scores: deque[float] = deque(maxlen=config.history)
        self._win_scores: list[float] = []
        self._win_escalated = 0
        self._win_requests = 0
        self._win_cost = 0.0
        self._ref_hist: np.ndarray | None = None
        self._bin_edges: np.ndarray | None = None
        # lifetime count of budget-eligible requests observed (policy-
        # blocked rows excluded, matching the window denominator). The
        # cluster reconciler uses deltas of this as per-replica traffic
        # weights (DESIGN.md §12).
        self.lifetime_requests = 0
        # observability (DESIGN.md §9): shared EventLog installed by the
        # Observability facade (None = disabled). ``event_window`` is the
        # engine window being committed when ``observe`` runs, so control
        # updates and drift flags carry the window that triggered them.
        self.events = None
        self.event_window: int | None = None

    # -- knobs the engine reads each batch ---------------------------------
    @property
    def t_local(self) -> float | None:
        return self.state.t_local

    @property
    def t_remote(self) -> float | None:
        return self.state.t_remote

    def capacity(self, batch_size: int) -> int:
        # before the first update t_local is None and the engine selects
        # exactly `capacity` rows, so slack must not apply (it would bake
        # a slack-times overshoot into the warm start)
        slack = self.config.capacity_slack if self.state.t_local is not None \
            else 1.0
        rho_cap = min(1.0, slack * self.state.rho)
        return escalation_capacity(batch_size, max(rho_cap, 1e-6))

    # -- cluster hooks (DESIGN.md §12) -------------------------------------
    def recent_scores(self) -> np.ndarray:
        """Rolling 1st-level score buffer as an array (newest last). The
        cluster reconciler pools these across replicas to place one
        global escalation threshold."""
        return np.asarray(self._scores, np.float64)

    def retarget(self, target_remote_fraction: float) -> None:
        """Push a new budget target (cluster reconcile). The PI loop
        keeps its integral — the clip bounds any stale correction — and
        converges on the new target from the next window on."""
        t = float(np.clip(target_remote_fraction, 0.0, 1.0))
        self.config = replace(self.config, target_remote_fraction=t)

    # -- observations the engine feeds back --------------------------------
    def observe(self, local_conf: np.ndarray, escalated: int,
                requests: int, remote_conf: np.ndarray | None = None,
                cost: float = 0.0, policy_blocked: int = 0) -> None:
        """Record one served batch (real rows only) and update per window.
        ``cost`` is the batch's realised billed $ (per-backend pricing), so
        the controller can hold a dollar budget (DESIGN.md §6).
        ``policy_blocked`` counts rows the per-request policy layer
        withheld from escalation (deadline/cost downgrades,
        ``escalation="never"`` — DESIGN.md §8): they are excluded from
        the realised-fraction denominator so the budget loop tracks the
        *eligible* population instead of chasing rows it can never
        escalate (which would drag ``t_local`` up and overspend on the
        rest)."""
        conf = np.asarray(local_conf, np.float64).ravel()
        self._scores.extend(conf.tolist())
        self._win_scores.extend(conf.tolist())
        self._win_escalated += int(escalated)
        eligible = max(int(requests) - int(policy_blocked), 0)
        self._win_requests += eligible
        self.lifetime_requests += eligible
        self._win_cost += float(cost)
        if remote_conf is not None:
            rc = np.asarray(remote_conf, np.float64).ravel()
            self._remote_scores.extend(rc[np.isfinite(rc)].tolist())
        # one update over everything accumulated — a window is "at least
        # cfg.window requests", never split (splitting would manufacture
        # empty phantom windows that drag the EMA toward zero)
        if self._win_requests >= self.config.window:
            self._update()

    # -- one control update ------------------------------------------------
    def _update(self) -> None:
        cfg, st = self.config, self.state
        frac = self._win_escalated / max(self._win_requests, 1)
        if st.windows == 0:
            st.ema_fraction = frac
        else:
            st.ema_fraction = (cfg.ema_alpha * frac
                               + (1 - cfg.ema_alpha) * st.ema_fraction)

        # learn the blended $ per escalation; a dollar budget re-derives
        # the target fraction each window (DESIGN.md §6)
        if self._win_escalated > 0:
            c = self._win_cost / self._win_escalated
            st.ema_cost_per_escalation = (
                c if st.ema_cost_per_escalation is None else
                cfg.cost_ema_alpha * c
                + (1 - cfg.cost_ema_alpha) * st.ema_cost_per_escalation)
        target = cfg.target_remote_fraction
        if (cfg.cost_budget_per_request is not None
                and st.ema_cost_per_escalation is not None):
            if st.ema_cost_per_escalation <= 0.0:
                target = 1.0    # free escalations: the $ budget never binds
            else:
                target = float(np.clip(
                    cfg.cost_budget_per_request
                    / st.ema_cost_per_escalation, 0.0, 1.0))
        st.effective_target = target

        err = st.ema_fraction - target
        st.integral = float(np.clip(st.integral + err,
                                    -cfg.integral_clip, cfg.integral_clip))

        drifted = self._detect_drift(np.asarray(self._win_scores))
        if drifted:
            st.drift_events += 1
            if self.events is not None:
                self.events.emit("controller_drift",
                                 window=self.event_window,
                                 psi=st.last_psi,
                                 threshold=self.config.drift_threshold,
                                 drift_events=st.drift_events)
            st.integral = 0.0
            st.ema_fraction = target
            err = 0.0

        # feed-forward escalation rate, PI-corrected, then realised as a
        # quantile of the recent score distribution
        st.rho = float(np.clip(
            target - cfg.kp * err - cfg.ki * st.integral, 0.0, 1.0))
        scores = (np.asarray(self._win_scores) if drifted
                  else np.asarray(self._scores))
        if scores.size:
            st.t_local = float(np.quantile(scores, st.rho))
        if len(self._remote_scores) >= 8:
            st.t_remote = float(np.quantile(
                np.asarray(self._remote_scores), cfg.target_rejection_rate))

        st.windows += 1
        if self.events is not None:
            # one bounded event per control window (not per batch): the
            # knob values the next windows will be served under
            self.events.emit("controller_update",
                             window=self.event_window,
                             rho=st.rho, t_local=st.t_local,
                             t_remote=st.t_remote,
                             ema_fraction=st.ema_fraction,
                             effective_target=st.effective_target)
        self._win_scores = []
        self._win_escalated = 0
        self._win_requests = 0
        self._win_cost = 0.0

    def _detect_drift(self, win_scores: np.ndarray) -> bool:
        cfg, st = self.config, self.state
        if win_scores.size == 0:
            return False
        if self._bin_edges is None:
            lo, hi = float(win_scores.min()), float(win_scores.max())
            span = max(hi - lo, 1e-6)
            self._bin_edges = np.linspace(lo - 0.1 * span, hi + 0.1 * span,
                                          cfg.drift_bins + 1)
            self._ref_hist = np.histogram(win_scores, self._bin_edges)[0]
            return False
        hist = np.histogram(win_scores, self._bin_edges)[0]
        st.last_psi = population_stability_index(self._ref_hist, hist)
        if st.last_psi > cfg.drift_threshold:
            # rebase the reference on the drifted distribution
            lo, hi = float(win_scores.min()), float(win_scores.max())
            span = max(hi - lo, 1e-6)
            self._bin_edges = np.linspace(lo - 0.1 * span, hi + 0.1 * span,
                                          cfg.drift_bins + 1)
            self._ref_hist = np.histogram(win_scores, self._bin_edges)[0]
            self._scores = deque(win_scores.tolist(),
                                 maxlen=self.config.history)
            return True
        # slow reference update so benign wander doesn't accumulate into
        # a spurious drift flag
        self._ref_hist = 0.9 * self._ref_hist + 0.1 * hist
        return False


# ---------------------------------------------------------------------------
# Per-tier budgets for N-tier hierarchies (DESIGN.md §13)
# ---------------------------------------------------------------------------

class TieredBudgetController:
    """One EMA/PI budget loop per cascade hop, reconciled to a global
    end-to-end budget.

    Each hop of an N-tier cascade (DESIGN.md §13) gets its own
    ``AdaptiveController`` tracking that hop's observed escalation
    fraction against a per-hop target. Because the fraction of traffic
    reaching the deepest tier is the *product* of the per-hop fractions,
    holding each hop loosely at its own target can still drift the
    end-to-end remote fraction off the global budget — so every
    ``reconcile_every`` hop-windows the controller re-centres: it takes
    the observed end-to-end fraction (product of per-hop EMAs), compares
    it to ``global_target``, and scales every hop's target by the n-th
    root of the ratio (clipped to ``[floor, 1]``). The same
    ``retarget`` hook the cluster reconciler uses (DESIGN.md §12)
    carries the correction, so each hop's PI loop converges on its new
    target from the next window on.

    ``loop(name)`` hands a hop's controller to its ``CascadeStage`` (or
    to the engine for hop 1); ``observe`` delegates by hop name and
    counts control windows to trigger the reconcile.
    """

    def __init__(self, hop_targets, *, global_target: float | None = None,
                 base: ControllerConfig = ControllerConfig(),
                 reconcile_every: int = 4, floor: float = 0.01):
        items = (list(hop_targets.items())
                 if isinstance(hop_targets, dict) else list(hop_targets))
        if not items:
            raise ValueError("need at least one hop")
        self.hops = [name for name, _ in items]
        self.loops = {
            name: AdaptiveController(
                replace(base, target_remote_fraction=float(t)))
            for name, t in items}
        prod = 1.0
        for _, t in items:
            prod *= float(t)
        self.global_target = float(global_target if global_target is not None
                                   else prod)
        self.reconcile_every = max(1, int(reconcile_every))
        self.floor = float(floor)
        self.reconciles = 0
        self._last_windows = 0
        # observability (installed like AdaptiveController.events)
        self.events = None
        self.event_window: int | None = None

    def loop(self, name: str) -> AdaptiveController:
        return self.loops[name]

    def _total_windows(self) -> int:
        return sum(self.loops[h].state.windows for h in self.hops)

    def observe(self, name: str, conf, escalated: int, requests: int,
                remote_conf=None, cost: float = 0.0) -> None:
        """Feed one hop's served batch to its loop; reconcile when
        enough control windows have elapsed across the hops."""
        self.loops[name].observe(conf, escalated, requests,
                                 remote_conf, cost=cost)
        self.tick()

    def tick(self) -> bool:
        """Reconcile iff enough control windows elapsed across the hops
        since the last one. The drive loop's hook when hops observe
        through their own ``AdaptiveController`` references (e.g. a
        ``CascadeStage`` holding ``loop(name)``) rather than through
        ``observe``."""
        if self._total_windows() - self._last_windows \
                >= self.reconcile_every:
            self.reconcile()
            return True
        return False

    def hop_fractions(self) -> dict[str, float]:
        """Per-hop observed escalation fraction (EMA; the hop's target
        until its first control window)."""
        out = {}
        for h in self.hops:
            lp = self.loops[h]
            out[h] = (lp.state.ema_fraction if lp.state.windows
                      else lp.config.target_remote_fraction)
        return out

    def end_to_end_fraction(self) -> float:
        """Observed fraction of traffic reaching past the last hop —
        the product of per-hop escalation fractions."""
        prod = 1.0
        for f in self.hop_fractions().values():
            prod *= f
        return prod

    def reconcile(self) -> dict:
        """Re-centre the per-hop targets on the global budget: scale each
        by the n-th root of target/observed (hops iterate in registration
        order, so the outcome is deterministic)."""
        self._last_windows = self._total_windows()
        observed = self.end_to_end_fraction()
        targets = {}
        if observed > 0.0:
            scale = (self.global_target / observed) ** (1.0 / len(self.hops))
            for h in self.hops:
                lp = self.loops[h]
                t = float(np.clip(lp.config.target_remote_fraction * scale,
                                  self.floor, 1.0))
                lp.retarget(t)
                targets[h] = t
        else:
            # nothing escalates anywhere: reopen every hop at the global
            # target's n-th root rather than steering on a zero product
            t0 = self.global_target ** (1.0 / len(self.hops))
            for h in self.hops:
                t = float(np.clip(t0, self.floor, 1.0))
                self.loops[h].retarget(t)
                targets[h] = t
        self.reconciles += 1
        if self.events is not None:
            self.events.emit("tier_reconcile",
                             window=self.event_window,
                             observed=observed,
                             global_target=self.global_target,
                             targets=targets,
                             reconciles=self.reconciles)
        return {"observed": observed, "targets": targets}
