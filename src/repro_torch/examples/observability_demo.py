"""Observability demo — a scripted outage, narrated by the telemetry, on
PyTorch.

The same cascade as ``adaptive_cascade``, but this time the point is what
you can SEE (DESIGN.md §9). Two remote backends serve a pipelined stream
behind a ``cheapest-available`` router; mid-run the cheap primary
suffers an outage. Instead of inferring what happened from aggregate
counters, the demo prints:

  * the structured EVENT LOG — every breaker open/half-open/close,
    router failover/fail-back and controller update, in the one global
    sequence order the components actually interleaved in;
  * a PER-REQUEST table built from trace spans — disposition, serving
    backend, realised $ cost, enqueue->hand-back latency and the
    dominant stage of each request's timeline;
  * the METRICS snapshot — and the proof that its commit-order cost
    counter reconciles bitwise with ``CascadeStats`` billing.

The counterpart of ``examples/observability_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.observability_demo [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime import (RemoteBackend, RemoteRouter, RemoteTimeout,
                                 TransportConfig)
from repro_torch.serving import ServeConfig
from repro_torch.serving.scheduler import Request

NCLS, BATCH = 8, 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    def make_requests(n, hard_frac=0.4):
        labels = rng.integers(0, NCLS, n)
        x = rng.normal(0, 0.05, (n, NCLS))
        margin = np.where(rng.random(n) < hard_frac,
                          rng.uniform(0.05, 0.4, n),
                          rng.uniform(2.0, 4.0, n))
        x[np.arange(n), labels] += margin
        return np.float32(x)

    @torch.no_grad()
    def local_apply(x):
        return x + 0.3 * torch.sin(17.0 * x)

    outage = {"on": False}

    def primary_fn(x):
        if outage["on"]:
            raise RemoteTimeout("primary brownout")
        time.sleep(0.03)
        return 5.0 * np.asarray(x)

    def secondary_fn(x):
        time.sleep(0.01)
        return 5.0 * np.asarray(x)

    tconf = TransportConfig(max_in_flight=BATCH, max_retries=0,
                            retry_backoff_s=0.0, timeout_s=5.0,
                            breaker_failures=2, breaker_reset_s=0.25)
    router = RemoteRouter(
        [RemoteBackend("cheap-slow", primary_fn, tconf,
                       cost_per_request=0.002, latency_s=0.03),
         RemoteBackend("pricey-fast", secondary_fn, tconf,
                       cost_per_request=0.008, latency_s=0.01)],
        policy="cheapest-available")

    # one flag turns the whole telemetry layer on (DESIGN.md §9)
    cfg = ServeConfig(batch_size=BATCH, remote_fraction_budget=0.4,
                      t_remote=0.0, pipeline_depth=2, observability=True)
    engine, sched = cfg.build(local_apply, transport=router,
                              fallback=lambda r: -1, device=dev)
    obs = engine.observability
    uid = 0

    def serve(n):
        nonlocal uid
        for row in make_requests(n):
            sched.submit(Request(uid=uid, local_input=row, remote_input=row))
            uid += 1
        return sched.flush()

    responses = []
    try:
        print("[phase 1] calm traffic ...")
        responses += serve(3 * BATCH)
        print("[phase 2] primary outage!")
        outage["on"] = True
        responses += serve(3 * BATCH)
        print("[phase 3] recovery ...")
        outage["on"] = False
        time.sleep(0.3)                 # let the breaker reset elapse
        responses += serve(3 * BATCH)
    finally:
        engine.close()

    # ---- the event log: silent transitions, in global sequence order ---
    print("\n=== EVENT LOG (what actually happened, in order) ===")
    events = obs.events.events()
    t0 = min(e["ts"] for e in events)
    for e in events:
        if e["event"] == "controller_update":
            continue            # one per window; too chatty for a demo
        extra = {k: v for k, v in e.items()
                 if k not in ("event", "seq", "ts", "window", "backend")
                 and v is not None}
        window = e["window"] if e["window"] is not None else "-"
        print(f"  seq {e['seq']:3d}  +{e['ts'] - t0:6.3f}s  "
              f"window {window:>3}  "
              f"{e['event']:<18} backend={e['backend'] or '-':<12} "
              + " ".join(f"{k}={v}" for k, v in sorted(extra.items())))

    # ---- per-request cost/latency table from the trace spans -----------
    spans = {s["uid"]: s for s in obs.trace.spans()}
    print(f"\n=== PER-REQUEST TABLE ({len(responses)} requests; "
          f"one span each) ===")
    print(f"  {'uid':>4} {'disposition':<12} {'backend':<12} {'cost':>8} "
          f"{'latency':>9}  dominant stage")
    shown = {r.uid: r for r in
             [r for r in responses if r.disposition != "LOCAL"][:6]
             + responses[:3]}
    for r in sorted(shown.values(), key=lambda r: r.uid):
        stages = spans[r.uid]["stages"]
        gaps = [(b[0], b[1] - a[1]) for a, b in zip(stages, stages[1:])]
        stage, dt = max(gaps, key=lambda g: g[1])
        print(f"  {r.uid:>4} {r.disposition:<12} {r.backend or '-':<12} "
              f"${r.cost:7.4f} {r.latency_s * 1e3:7.1f}ms  "
              f"{stage} ({dt * 1e3:.1f}ms)")
    print(f"  ... ({len(responses) - len(shown)} more; full timelines go to "
          f"--trace / --trace-chrome in launch/serve.py)")

    # ---- metrics snapshot reconciles bitwise with billing ---------------
    c = obs.metrics.snapshot()["counters"]
    st = engine.stats
    by_backend = {u: round(v.cost, 4) for u, v in st.per_backend.items()}
    print("\n=== METRICS ===")
    print(f"  requests={c['cascade_requests_total']} "
          f"escalations={c['cascade_escalations_total']} "
          f"remote_calls={c['cascade_remote_calls_total']} "
          f"transport_failures={c['cascade_transport_failures_total']}")
    bitwise = c["cascade_cost_dollars_total"] == st.total_cost
    print(f"  cost counter ${c['cascade_cost_dollars_total']:.4f} "
          f"== stats.total_cost ${st.total_cost:.4f} (bitwise: "
          f"{bitwise}) per-backend {by_backend}")
    span_cost = sum(s["cost"] for s in spans.values())
    print(f"  span costs sum ${span_cost:.4f}; "
          f"events={dict(sorted(obs.events.counts().items()))}")

    assert len(responses) == len(spans) == st.requests == 9 * BATCH
    assert bitwise, "the cost counter does not reconcile with billing"
    assert np.isclose(span_cost, st.total_cost, rtol=1e-9, atol=1e-12)
    assert obs.events.counts().get("breaker_open", 0) > 0
    return {"requests": st.requests, "total_cost": st.total_cost,
            "events": dict(obs.events.counts()), "per_backend": by_backend}


if __name__ == "__main__":
    main()
