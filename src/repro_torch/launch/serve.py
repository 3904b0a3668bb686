"""Cascade serving entry point — BiSupervised as a deployable two-tier runtime,
on PyTorch and one GPU.

The port of ``repro.launch.serve``: the same flags, plus ``--device
{cuda,cpu}`` (default ``cuda``; a missing GPU is an error, never a quiet
fallback to the CPU).

Local tier: a trained surrogate classifier. Remote tier: the model of
``--remote-arch`` (yi-6b by default; any arch with a token embedding —
the attention family, rwkv6-1.6b, the zamba2 hybrid and pixtral-12b,
which serves the token task through a tokens prefill as JAX's does; an
arch that takes embeddings only, hubert-xlarge, is refused), at full
width unless ``--smoke``, reached through the
fault-aware transport with a content-keyed response cache. The 1st-level
supervisor escalates the lowest-confidence requests through the
on-device confidence gate; the 2nd-level supervisor filters untrusted
remote predictions (fallback).

The serving surface is ONE ``ServeConfig``; any field is set with a
repeatable ``--set key=value`` (nested ``transport.*``, ``cost.*``,
``default_policy.*`` too). Observability: ``--metrics-dump``,
``--metrics-interval``, ``--metrics-port``, ``--trace``,
``--trace-chrome``. ``tiers`` and ``replicas > 1`` are not ported yet.

``main`` is three calls, which callers that need the built stack (the
chip smoke test) make themselves: ``parse_args`` -> ``build_stack``
(task, surrogate training, remote model, calibration) -> ``run`` (serve
the requests through the engine and scheduler, print the report).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 256 \\
        --batch 32 --remote-budget 0.3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.thresholds import nominal_quantile_threshold
from repro_torch.data.synthetic import make_classification_task
from repro_torch.device import resolve_device
from repro_torch.models import surrogate as S
from repro_torch.models import transformer as T
from repro_torch.runtime import (calibrate, content_key, content_keys,
                                 to_host)
from repro_torch.serving import Request, ServeConfig
from repro_torch.serving.engine import CostModel
from repro_torch.tree import tree_leaves, tree_like, tree_map
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


def train_surrogate(cfg, toks, labels, steps=60, lr=3e-3, seed=0,
                    device: str | torch.device = "cuda"):
    """AdamW on the surrogate's loss; returns (params, final loss)."""
    dev = resolve_device(device)
    params = S.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    opt = init_opt_state(params)
    ocfg = AdamWConfig(lr=lr, warmup_steps=5, weight_decay=0.0)
    toks = torch.as_tensor(toks, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    drop = torch.Generator(dev).manual_seed(1)
    loss = torch.zeros(())
    for _ in range(steps):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = S.loss_fn(cfg, params, toks, labels, drop)
        grads = tree_like(params, torch.autograd.grad(loss, leaves))
        params, opt, _ = adamw_update(
            ocfg, tree_map(torch.Tensor.detach, params), grads, opt)
    return params, float(loss.detach())


def build_serve_config(args) -> ServeConfig:
    """One ``ServeConfig`` from the CLI: first-class workload flags, then
    the repeatable ``--set key=value`` field overrides."""
    cfg = ServeConfig(
        batch_size=args.batch,
        remote_fraction_budget=args.remote_budget,
        target_rejection_rate=args.fpr,
        adaptive=args.adaptive,
        fused=args.fused,
        cost=CostModel())
    return cfg.with_overrides(args.set or [])


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--remote-arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tiers and kernels run (default cuda)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--remote-budget", type=float, default=0.3,
                    help="capacity fraction escalated to the remote tier")
    ap.add_argument("--fpr", type=float, default=0.05,
                    help="2nd-level supervisor nominal false-alarm rate")
    ap.add_argument("--fused", action="store_true",
                    help="one fused cascade step (no transport)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online EMA/PID budget controller")
    ap.add_argument("--calibrate", action="store_true",
                    help="offline Pareto sweep for (t_local, t_remote, k)")
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE",
                    help="ServeConfig field override, repeatable — any "
                         "field incl. nested transport.* / cost.* / "
                         "default_policy.*")
    ap.add_argument("--metrics-dump", metavar="PATH",
                    help="write the final metrics snapshot here: JSON "
                         "for *.json, Prometheus exposition text "
                         "otherwise (implies observability)")
    ap.add_argument("--metrics-interval", type=float, metavar="S",
                    help="re-dump/print metrics every S seconds while "
                         "serving (implies observability)")
    ap.add_argument("--metrics-port", type=int, metavar="PORT",
                    help="serve the live metrics registry over HTTP on "
                         "this port (implies observability)")
    ap.add_argument("--trace", metavar="PATH",
                    help="write per-request span timelines as JSONL "
                         "(implies observability)")
    ap.add_argument("--trace-chrome", metavar="PATH",
                    help="write Chrome trace_event JSON (implies "
                         "observability)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate the flags; ``args.serve_config`` holds the
    ``ServeConfig`` and ``args.device`` the resolved ``torch.device``."""
    ap = _parser()
    args = ap.parse_args(argv)
    want_obs = (args.metrics_dump or args.metrics_interval
                or args.metrics_port is not None
                or args.trace or args.trace_chrome)
    try:
        cfg = build_serve_config(args)
        if want_obs:
            if cfg.fused:
                ap.error("--metrics-dump/--metrics-interval/--trace "
                         "require the transport path (not --fused)")
            cfg = dataclasses.replace(cfg, observability=True)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    if (cfg.cost_budget is not None and not cfg.adaptive
            and not args.calibrate):
        ap.error("cost_budget is only enforced by the controller or the "
                 "offline sweep; add --adaptive and/or --calibrate")
    try:
        rcfg = get_config(args.remote_arch)
        args.device = resolve_device(args.device)
    except (KeyError, RuntimeError) as e:
        ap.error(str(e))
    if not T.takes_tokens(rcfg):
        # JAX's remote tier fails at its prefill's input assertion
        ap.error(f"--remote-arch {args.remote_arch}: the remote tier "
                 f"serves a token task, and {rcfg.name} has no token "
                 f"embedding (it takes frontend embeddings only)")
    args.serve_config = cfg
    return args


@dataclass
class Stack:
    """What ``build_stack`` made: the task, both tiers and the calibrated
    ``ServeConfig``."""
    device: torch.device
    cfg: ServeConfig
    scfg: S.SurrogateConfig
    sparams: dict
    rcfg: Any
    rparams: dict
    local_apply: Callable
    remote_apply: Callable
    toks: np.ndarray
    local_toks: np.ndarray
    labels: np.ndarray


def _router_and_cache(cfg: ServeConfig, remote_apply):
    if cfg.fused:
        return None, None
    router = cfg.build_router(remote_apply)
    # key on token content only: the per-request "idx" (oracle-head
    # plumbing) would make every key unique and the cache cold
    cache = cfg.build_cache(
        key_fn=lambda row: content_key(row["tokens"]),
        key_batch_fn=lambda batch, n: content_keys(batch["tokens"], n))
    return router, cache


def build_stack(args) -> Stack:
    dev = args.device
    cfg = args.serve_config

    # ---- task + local surrogate (paper §4.1: input-domain-reduced) ----
    vocab, seq, ncls = 512, 48, 8
    n = max(args.requests, 512)
    toks, labels, _ = make_classification_task(
        1, n=n, vocab=vocab, seq_len=seq, num_classes=ncls)
    scfg = S.SurrogateConfig("local", vocab_size=vocab // 4, max_len=seq // 2,
                             d_model=32, num_heads=2, d_ff=32,
                             num_classes=ncls, dropout=0.0)
    # input-domain reduction: clipped seq, folded vocab
    local_toks = (toks[:, : seq // 2] % (vocab // 4)).astype(np.int32)
    sparams, sloss = train_surrogate(scfg, local_toks[:512], labels[:512],
                                     device=dev)
    print(f"[serve] local surrogate trained (final loss {sloss:.3f})")

    # ---- remote tier: the full-width model, drawn on the device ----
    rcfg = get_config(args.remote_arch)
    if args.smoke:
        rcfg = rcfg.reduced()
    rparams = T.init_params(rcfg, torch.Generator(dev).manual_seed(7))
    print(f"[serve] remote tier {rcfg.name} on {dev}")

    # the remote model consumes the FULL input; its last-position logits
    # jitter an oracle readout so the remote tier is accurate (stands in
    # for a GPT-3-quality model, as in the paper's case studies)
    oracle = F.one_hot(torch.as_tensor(labels, device=dev).long(),
                       ncls).float() * 8.0

    @torch.no_grad()
    def remote_apply(batch):
        toks_full = torch.as_tensor(batch["tokens"], device=dev)
        idx = torch.as_tensor(batch["idx"], device=dev).long()
        logits, _ = T.prefill(rcfg, rparams, {"tokens": toks_full})
        jitter = 0.01 * logits[:, :ncls].float()
        return oracle[idx] + jitter

    @torch.no_grad()
    def local_apply(tk):
        return S.apply(scfg, sparams, tk)

    # an explicit --set t_remote/t_local always wins over the computed
    # thresholds below
    user_set = {item.partition("=")[0].strip() for item in (args.set or [])}

    # ---- 2nd-level threshold: nominal-quantile calibration (§4.5) ----
    cal_logits = to_host(remote_apply(
        {"tokens": toks[:128] % rcfg.vocab_size, "idx": np.arange(128)}))
    cal_conf = np.max(
        np.exp(cal_logits) / np.exp(cal_logits).sum(-1, keepdims=True), -1)
    if "t_remote" not in user_set:
        cfg = dataclasses.replace(
            cfg, t_remote=nominal_quantile_threshold(cal_conf, args.fpr))

    if args.calibrate:
        # offline Pareto sweep on a labelled validation slice, priced at
        # the policy-preferred backend's per-call cost
        nval = cal_logits.shape[0]
        val_logits = to_host(local_apply(
            torch.as_tensor(local_toks[:nval], device=dev)))
        val_sm = np.exp(val_logits) / np.exp(val_logits).sum(-1, keepdims=1)
        esc_cost = (cfg.cost or CostModel()).remote_cost_per_request
        router, _ = _router_and_cache(cfg, remote_apply)
        if router is not None:
            esc_cost = router.expected_cost_per_escalation(esc_cost)
            router.shutdown()
        point, k, front = calibrate(
            local_conf=val_sm.max(-1),
            local_correct=val_logits.argmax(-1) == labels[:nval],
            remote_conf=cal_conf,
            remote_correct=cal_logits.argmax(-1) == labels[:nval],
            budget=(None if cfg.cost_budget is not None
                    else cfg.remote_fraction_budget),
            cost_budget=cfg.cost_budget, batch_size=cfg.batch_size,
            max_rejection_rate=args.fpr, remote_cost_per_request=esc_cost)
        cal_updates = {}
        if "t_local" not in user_set:
            cal_updates["t_local"] = point.t_local
        if "t_remote" not in user_set:
            cal_updates["t_remote"] = point.t_remote
        cfg = dataclasses.replace(cfg, **cal_updates)
        print(f"[serve] calibrated operating point: "
              f"t_local={point.t_local:.4f} "
              f"t_remote={point.t_remote:.4f} k={k} "
              f"(val remote fraction {point.remote_fraction:.2f}, "
              f"${point.cost_per_request:.5f}/req, "
              f"accepted acc {point.accuracy:.3f}; "
              f"frontier has {len(front)} points)")
    return Stack(device=dev, cfg=cfg, scfg=scfg, sparams=sparams, rcfg=rcfg,
                 rparams=rparams, local_apply=local_apply,
                 remote_apply=remote_apply, toks=toks, local_toks=local_toks,
                 labels=labels)


@dataclass
class ServeResult:
    responses: list
    engine: Any
    scheduler: Any
    wall_s: float


def run(args, stack: Stack, local_apply: Callable | None = None,
        requests: int | None = None) -> ServeResult:
    """Build the engine and scheduler from ``stack.cfg`` around
    ``local_apply`` (the stack's surrogate by default), serve ``requests``
    requests (``args.requests`` by default) and print the report."""
    cfg, dev = stack.cfg, stack.device
    local_apply = local_apply or stack.local_apply
    n_req = args.requests if requests is None else requests
    router, cache = _router_and_cache(cfg, stack.remote_apply)
    if router is not None:
        print(f"[serve] remote registry: "
              f"{[b.name for b in router.candidates()]} "
              f"(policy {router.policy})")
    if cfg.fused:
        eng, sched = cfg.build(local_apply, stack.remote_apply,
                               fallback=lambda r: -1, device=dev)
    else:
        eng, sched = cfg.build(local_apply, transport=router, cache=cache,
                               fallback=lambda r: -1, device=dev)
    obs = eng.observability

    def dump_metrics(path):
        if path.endswith(".json"):
            text = json.dumps(obs.metrics.snapshot(), indent=2,
                              sort_keys=True) + "\n"
        else:
            text = obs.metrics.render_prometheus()
        with open(path, "w") as f:
            f.write(text)

    stop_pump = threading.Event()

    def pump():
        while not stop_pump.wait(args.metrics_interval):
            if args.metrics_dump:
                dump_metrics(args.metrics_dump)
            else:
                c = obs.metrics.snapshot()["counters"]
                print(f"[serve] metrics: "
                      f"{c.get('cascade_requests_total', 0):.0f} requests, "
                      f"{c.get('cascade_escalations_total', 0):.0f} "
                      f"escalated, "
                      f"${c.get('cascade_cost_dollars_total', 0.0):.4f}")

    pump_thread = None
    if obs is not None and args.metrics_interval:
        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()
    metrics_server = None
    if obs is not None and args.metrics_port is not None:
        from repro_torch.runtime.observability import MetricsServer
        metrics_server = MetricsServer(obs.metrics, port=args.metrics_port)
        print(f"[serve] metrics endpoint: {metrics_server.url}")

    toks, local_toks, labels = stack.toks, stack.local_toks, stack.labels
    t0 = time.perf_counter()
    try:
        for i in range(n_req):
            sched.submit(Request(
                uid=i, local_input=local_toks[i],
                remote_input={"tokens": toks[i] % stack.rcfg.vocab_size,
                              "idx": np.int32(i)}))
        responses = sched.flush()
    finally:
        eng.close()     # drain windows + shut down every backend pool
        if pump_thread is not None:
            stop_pump.set()
            pump_thread.join(timeout=5.0)
        if metrics_server is not None:
            metrics_server.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    _report(args, cfg, eng, sched, router, responses, labels, wall)
    if obs is not None and args.metrics_dump:
        dump_metrics(args.metrics_dump)
        print(f"[serve] wrote metrics snapshot -> {args.metrics_dump}")
    return ServeResult(responses, eng, sched, wall)


def _report(args, cfg, eng, sched, router, responses, labels, wall) -> None:
    correct = sum(r.prediction == labels[r.uid] for r in responses
                  if r.source != "fallback")
    srcs = {s: sum(r.source == s for r in responses)
            for s in ("local", "remote", "fallback")}
    st = eng.stats
    print(f"[serve] {len(responses)} requests in {wall:.1f}s wall")
    print(f"[serve] routing: {srcs}")
    print(f"[serve] dispositions: "
          f"{dict(Counter(r.disposition for r in responses))}")
    print(f"[serve] accepted accuracy: "
          f"{correct / max(len(responses) - srcs['fallback'], 1):.3f}")
    print(f"[serve] remote fraction: {st.remote_fraction:.2f} "
          f"(budget {cfg.remote_fraction_budget})")
    print(f"[serve] modelled cost: ${st.total_cost:.4f} "
          f"(${st.total_cost / max(st.requests, 1):.5f}/req; remote-only "
          f"would be ${st.requests * eng.cost.remote_cost_per_request:.4f})")
    if st.mean_latency_s is not None:
        print(f"[serve] modelled mean latency: "
              f"{st.mean_latency_s * 1e3:.0f} ms "
              f"(remote-only {eng.cost.remote_latency_s * 1e3:.0f} ms)")
    p50, p95 = st.wall_percentile(50), st.wall_percentile(95)
    if p50 is not None:
        print(f"[serve] measured wall latency: "
              f"p50 {p50 * 1e3:.0f} ms, p95 {p95 * 1e3:.0f} ms "
              f"(throughput {len(responses) / max(wall, 1e-9):.0f} req/s, "
              f"pipeline depth {cfg.pipeline_depth}, "
              f"completion mode {cfg.completion_mode})")
    if sched.first_response_s is not None:
        print(f"[serve] first response: "
              f"{sched.first_response_s * 1e3:.0f} ms after flush start")
    lat_local = [r.latency_s for r in responses if r.source == "local"]
    lat_esc = [r.latency_s for r in responses if r.source != "local"]
    for tag, lat in (("trusted-local", lat_local), ("escalated", lat_esc)):
        if lat:
            print(f"[serve] {tag} hand-back latency: "
                  f"p50 {np.percentile(lat, 50) * 1e3:.0f} ms, "
                  f"p95 {np.percentile(lat, 95) * 1e3:.0f} ms "
                  f"({len(lat)} requests)")
    if cfg.packing != "none":
        ps = sched.packing_stats
        pure = ps["cold"] + ps["hot"]
        print(f"[serve] window packing: {ps} "
              f"(purity {pure / max(ps['windows'], 1):.2f})")
    if cfg.admission_limit:
        ad = sched.admission
        print(f"[serve] admission: {ad.submitted} submitted, "
              f"{ad.shed} shed {ad.shed_reasons}, "
              f"{ad.degraded} degraded {ad.degrade_reasons} "
              f"(queue limit {sched.admission_limit}, "
              f"soft {sched.admission_soft})")
    if router is not None:
        rs = router.stats
        print(f"[serve] router: picks {rs.picks}, "
              f"failovers {rs.failovers}, unrouted {rs.unrouted}, "
              f"replays {rs.replay_served}/{rs.replay_enqueued} served")
        for b in router:
            ts, u = b.stats, st.per_backend.get(b.name)
            p95r = ts.latency_percentile(95)
            line = (f"[serve]   {b.name}: {ts.windows} windows, "
                    f"{ts.failed_requests} failed reqs, "
                    f"{ts.retries} retries, "
                    f"breaker opens {ts.breaker_opens}, "
                    f"p95 remote "
                    f"{'n/a' if p95r is None else f'{p95r * 1e3:.0f} ms'}")
            if u is not None:
                line += (f"; billed ${u.cost:.4f} "
                         f"({u.remote_calls} calls, {u.cache_hits} hits, "
                         f"{u.transport_failures} failures)")
            print(line)
    if eng.cache is not None:
        hr = eng.cache.stats.hit_rate
        print(f"[serve] cache: {eng.cache.stats.hits} hits / "
              f"{eng.cache.stats.misses} misses "
              f"(hit rate {'n/a' if hr is None else f'{hr:.2f}'})")
    if eng.controller is not None:
        cs = eng.controller.state
        print(f"[serve] controller: {cs.windows} windows, "
              f"ema remote fraction {cs.ema_fraction:.3f}, "
              f"t_local={cs.t_local}, t_remote={cs.t_remote}, "
              f"{cs.drift_events} drift events")
    obs = eng.observability
    if obs is not None:
        evc = obs.events.counts()
        if evc:
            print(f"[serve] events: {dict(sorted(evc.items()))}")
        if args.trace:
            n = obs.trace.write_jsonl(args.trace)
            print(f"[serve] wrote {n} spans -> {args.trace}")
        if args.trace_chrome:
            n = obs.trace.write_chrome_trace(args.trace_chrome)
            print(f"[serve] wrote {n} trace events -> {args.trace_chrome}")


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args, build_stack(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
