"""Adaptive cascade demo — the full runtime control plane on a drifting
workload with a mid-episode remote outage, on PyTorch.

A stream of synthetic requests flows through the BiSupervised cascade
composed with the ``repro_torch.runtime`` control plane (DESIGN.md):

  1. OFFLINE  — a labelled validation slice is swept into a cost/accuracy
     Pareto frontier; the operating point for a 20% remote budget seeds
     ``(t_local, t_remote, k)``.
  2. ONLINE   — traffic drifts (hard-input rate 10% -> 40%); the
     EMA/PID controller detects the drift on its score histograms and
     retunes the thresholds so the remote bill stays on budget.
  3. OUTAGE   — the remote tier times out for a stretch; the circuit
     breaker opens, escalations degrade to the fallback answer (nobody's
     request is dropped), and the half-open probe restores service.
  4. DEDUP    — duplicate requests are served from the content-keyed
     cache and never re-billed.

The counterpart of ``examples/adaptive_cascade.py``; the local tier and
its gate run on ``--device``. ``--scale`` multiplies every phase's
request count (1.0: the JAX example's 2048/4096/1024/1024/2048).

    PYTHONPATH=src python -m repro_torch.examples.adaptive_cascade [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime import (AdaptiveController, ControllerConfig,
                                 RemoteResponseCache, RemoteTimeout,
                                 RemoteTransport, TransportConfig, calibrate)
from repro_torch.serving import ServeConfig
from repro_torch.serving.scheduler import Request

NCLS, BATCH, BUDGET = 8, 32, 0.20


def softmax_conf(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).max(-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    def make_requests(n, hard_frac):
        labels = rng.integers(0, NCLS, n)
        x = rng.normal(0, 0.05, (n, NCLS))
        margin = np.where(rng.random(n) < hard_frac,
                          rng.uniform(0.05, 0.4, n),
                          rng.uniform(2.0, 4.0, n))
        x[np.arange(n), labels] += margin
        return np.float32(x), labels

    @torch.no_grad()
    def local_apply(x):
        return x + 0.3 * torch.sin(17.0 * x)

    clock = {"t": 0.0}
    outage = {"on": False}

    def remote_apply(x):
        clock["t"] += 0.01
        if outage["on"]:
            raise RemoteTimeout("remote tier unreachable")
        return 5.0 * np.asarray(x)

    # ---- 1. offline calibration on a labelled validation slice ----------
    val_x, val_y = make_requests(1024, 0.15)
    local_logits = local_apply(torch.from_numpy(val_x)).numpy()
    remote_logits = 5.0 * val_x
    point, k, frontier = calibrate(
        local_conf=softmax_conf(local_logits),
        local_correct=local_logits.argmax(-1) == val_y,
        remote_conf=softmax_conf(remote_logits),
        remote_correct=remote_logits.argmax(-1) == val_y,
        budget=BUDGET, batch_size=BATCH)
    print(f"[calibrate] Pareto frontier: {len(frontier)} points; picked "
          f"t_local={point.t_local:.3f} t_remote={point.t_remote:.3f} k={k} "
          f"(val: {point.remote_fraction:.0%} remote, "
          f"{point.accuracy:.3f} accepted acc)")

    # ---- 2. compose the runtime -----------------------------------------
    transport = RemoteTransport(
        remote_apply,
        TransportConfig(max_in_flight=8, timeout_s=1.0, max_retries=1,
                        retry_backoff_s=0.0, breaker_failures=2,
                        breaker_reset_s=0.5),
        clock=lambda: clock["t"], sleep=lambda s: None)
    controller = AdaptiveController(ControllerConfig(
        target_remote_fraction=BUDGET, window=256))
    # the whole serving stack comes from ONE ServeConfig (DESIGN.md §8)
    cfg = ServeConfig(batch_size=BATCH, remote_fraction_budget=BUDGET,
                      t_remote=point.t_remote, t_local=point.t_local)
    engine, sched = cfg.build(local_apply, transport=transport,
                              controller=controller,
                              cache=RemoteResponseCache(4096),
                              fallback=lambda r: -1, device=dev)
    uid = 0
    served = 0

    def serve(n, hard_frac, dup_frac=0.0):
        nonlocal uid, served
        n = max(BATCH, int(n * args.scale))
        xs, _ = make_requests(n, hard_frac)
        if dup_frac > 0:       # resubmit a slice of known-hard duplicates
            ndup = int(n * dup_frac)
            xs[:ndup] = xs[rng.integers(n - ndup, n, ndup)]
        for row in xs:
            sched.submit(Request(uid=uid, local_input=row, remote_input=row))
            uid += 1
        rs = sched.flush()
        assert len(rs) == n, f"answered {len(rs)} of {n}"
        served += n
        return {s: sum(r.source == s for r in rs)
                for s in ("local", "remote", "fallback")}

    try:
        st = engine.stats
        print(f"\n[phase 1] calm traffic (10% hard): {serve(2048, 0.10)}")
        print(f"          remote fraction {st.remote_fraction:.2f} "
              f"(budget {BUDGET})")

        print(f"\n[phase 2] drift! (40% hard): {serve(4096, 0.40)}")
        cs = controller.state
        print(f"          remote fraction {st.remote_fraction:.2f}, "
              f"controller saw {cs.drift_events} drift event(s), "
              f"t_local -> {cs.t_local:.3f}")

        outage["on"] = True
        out3 = serve(1024, 0.40)
        print(f"\n[phase 3] remote outage: {out3}")
        outage["on"] = False
        clock["t"] += 1.0
        print(f"          breaker: {transport.stats.breaker_opens} open(s), "
              f"{transport.stats.short_circuited} short-circuited, "
              f"state={transport.breaker.state}")
        print(f"[phase 3b] recovery: {serve(1024, 0.40)} "
              f"(breaker {transport.breaker.state})")

        print(f"\n[phase 4] duplicate-heavy: "
              f"{serve(2048, 0.40, dup_frac=0.5)}")
        print(f"          cache: {engine.cache.stats.hits} hits "
              f"(rate {engine.cache.stats.hit_rate or 0.0:.2f})")
    finally:
        engine.close()

    print(f"\n[total] {st.requests} requests, {st.escalations} escalations, "
          f"{st.remote_calls} billed remote calls, {st.cache_hits} cache "
          f"hits, {st.transport_failures} transport failures")
    print(f"[total] bill ${st.total_cost:.4f} vs remote-only "
          f"${st.requests * engine.cost.remote_cost_per_request:.4f}; "
          f"mean latency {(st.mean_latency_s or 0.0) * 1e3:.0f} ms vs "
          f"remote-only {engine.cost.remote_latency_s * 1e3:.0f} ms")

    # nobody's request is dropped: the outage degrades to the fallback
    assert st.requests == served
    assert out3["fallback"] > 0 and transport.stats.breaker_opens > 0
    assert transport.breaker.state == "closed"
    assert st.escalations == st.remote_calls + st.cache_hits \
        + st.transport_failures
    assert engine.cache.stats.hits > 0
    return {"requests": st.requests, "escalations": st.escalations,
            "remote_calls": st.remote_calls, "cache_hits": st.cache_hits,
            "transport_failures": st.transport_failures,
            "breaker_opens": transport.stats.breaker_opens,
            "total_cost": st.total_cost}


if __name__ == "__main__":
    main()
