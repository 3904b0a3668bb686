"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. In order, it

1. requires a CUDA device and prints the card's name and power limit;
2. builds every hand-written kernel from ``src/repro_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at yi-6b's widths, and times kernel, plain
   version and (where one PyTorch call computes the same function) the
   library call with CUDA events;
4. checks the remote model's prefill on the card against the CPU on a
   reduced config, then serves 256 requests through
   ``repro_torch.launch.serve`` with yi-6b at full width as the remote
   tier, and 64 more through an engine whose local tier is a
   ``FusedLocalHead`` over the same surrogate, asserting that every
   request is answered, that billing reconciles and that each kernel ran
   on those paths;
5. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero without the last line. Full results are also
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}   # dense, data sheet
SERVE_ARGV = ["--requests", "256", "--batch", "32", "--remote-budget", "0.3"]
FUSED_REQUESTS = 64
CONF_TOL = 1e-4        # the gate kernels' confidence tolerance (conf <= 1)
RESULTS: dict = {"phases": {}}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, samples: int = 25, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``samples`` of (CUDA-event time of ``inner`` back-to-back
    calls) / ``inner``, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate vs
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------
# inputs (numpy seeds) with the gaps the exact checks need
# ----------------------------------------------------------------------------

GAP = 1e-3


def gaps_ok(logits: torch.Tensor, conf: torch.Tensor, n_valid: int,
            t_local: float) -> bool:
    """Top-2 logit gap per row and confidence gaps between valid rows and
    around t_local all exceed GAP, so pred and idx are decided exactly."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    c = torch.sort(conf[:n_valid].double()).values
    return bool((top2[:, 0] - top2[:, 1]).min() > GAP
                and (c[1:] - c[:-1]).min() > GAP
                and (conf[:n_valid].double() - t_local).abs().min() > GAP)


def planted_logits(rng, b: int, c: int) -> np.ndarray:
    """Normal logits with one planted maximum per row, its height spread
    over the rows so confidences differ."""
    x = rng.standard_normal((b, c)).astype(np.float32)
    height = (8.0 + 0.25 * rng.permutation(b)) if c > 64 else \
        (1.0 + 0.15 * rng.permutation(b))
    x[np.arange(b), rng.integers(0, c, b)] = height
    return x


def mid_threshold(conf: torch.Tensor, n_valid: int) -> float:
    """A t_local halfway between two neighbouring valid confidences in
    the middle of the batch (so the threshold, not k, cuts the set)."""
    c = np.sort(conf[:n_valid].double().cpu().numpy())
    i = len(c) // 2
    return float((c[i - 1] + c[i]) / 2)


# ----------------------------------------------------------------------------
# kernel phase
# ----------------------------------------------------------------------------

def check_gate(dev, b: int, c: int, seed: int) -> dict:
    from repro_torch.core.supervisors import max_softmax
    from repro_torch.kernels.confidence_gate import kernel as gk
    from repro_torch.kernels.confidence_gate import ops as gops
    from repro_torch.kernels.confidence_gate.ref import (confidence_gate_ref,
                                                         select_ref)
    n_valid = b - 3
    for s in range(seed, seed + 20):
        rng = np.random.default_rng(s)
        logits = torch.from_numpy(planted_logits(rng, b, c)).to(dev)
        conf_p = max_softmax(logits)
        t = mid_threshold(conf_p, n_valid)
        if gaps_ok(logits, conf_p, n_valid, t):
            break
    else:
        raise AssertionError(f"no gate input with gaps > {GAP} at [{b},{c}]")
    got = gops.confidence_gate(logits, t, n_valid)
    want = confidence_gate_ref(logits, t, n_valid)
    torch.cuda.synchronize()
    err = float((got["conf"] - want["conf"]).abs().max())
    assert torch.allclose(got["conf"], want["conf"], rtol=1e-4, atol=1e-6), \
        f"gate conf [{b},{c}] max err {err}"
    assert torch.equal(got["pred"], want["pred"]), f"gate pred [{b},{c}]"
    assert torch.equal(got["idx"], want["idx"]), \
        f"gate idx [{b},{c}]: {got['idx'].tolist()} vs {want['idx'].tolist()}"

    tt = torch.tensor(t, dtype=torch.float32, device=dev)
    nn = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    score_ms = time_ms(lambda: gk.gate_score(logits, "max_softmax"))
    score_plain = time_ms(lambda: (max_softmax(logits),
                                   logits.argmax(-1).int()))
    conf = got["conf"]
    select_ms = time_ms(lambda: gk.gate_select(conf, tt, nn, b))
    select_plain = time_ms(lambda: select_ref(conf, tt, nn, b))
    sb, sby = bound(b * c * 4 + b * 8, 6.0 * b * c, "fp32")
    lb, lby = bound(b * 4 + 8 + b * 4, 4.0 * b * b, "fp32")
    rows = [
        {"kernel": "gate_score", "shape": [b, c], "dtype": "float32",
         "max_abs_err": err, "kernel_ms": score_ms, "plain_ms": score_plain,
         "library_ms": None, "bound_ms": sb, "bound_by": sby},
        {"kernel": "gate_select", "shape": [b], "dtype": "float32",
         "max_abs_err": float((got["idx"] - want["idx"]).abs().max()),
         "kernel_ms": select_ms, "plain_ms": select_plain,
         "library_ms": None, "bound_ms": lb, "bound_by": lby},
    ]
    for r in rows:
        log(r)
    return {r["kernel"]: r for r in rows}


def check_fused_head(dev, b: int, d: int, c: int, w_dtype, seed: int) -> dict:
    from repro_torch.kernels.fused_head_gate import kernel as fk
    from repro_torch.kernels.fused_head_gate import ops as fops
    from repro_torch.kernels.fused_head_gate.ref import (fused_head_gate_ref,
                                                         head_logits)
    from repro_torch.core.supervisors import max_softmax
    n_valid = b - 3
    for s in range(seed, seed + 20):
        rng = np.random.default_rng(s)
        h = rng.standard_normal((b, d)).astype(np.float32)
        w = (rng.standard_normal((d, c), dtype=np.float32)
             / np.float32(math.sqrt(d)))
        if c > 64:
            # plant a large logit for each row: w[:, c_r] += m_r h_r/|h_r|^2
            cols = rng.choice(c, b, replace=False)
            m = 8.0 + 0.25 * rng.permutation(b)
            w[:, cols] += (h / (h * h).sum(1, keepdims=True)
                           * m[:, None]).T.astype(np.float32)
        bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
        hd_, wd_ = torch.from_numpy(h).to(dev), \
            torch.from_numpy(w).to(dev).to(w_dtype)
        bd_ = torch.from_numpy(bias).to(dev)
        del w
        logits = head_logits(hd_, wd_, bd_)
        conf_p = max_softmax(logits)
        t = mid_threshold(conf_p, n_valid)
        ok = gaps_ok(logits, conf_p, n_valid, t)
        del logits
        if ok:
            break
    else:
        raise AssertionError(f"no head input with gaps > {GAP} at "
                             f"[{b},{d}]x[{d},{c}]")
    got = fops.fused_head_gate(hd_, wd_, bd_, t, n_valid)
    want = fused_head_gate_ref(hd_, wd_, bd_, t, n_valid)
    torch.cuda.synchronize()
    err = float((got["conf"] - want["conf"]).abs().max())
    tag = f"[{b},{d}]x[{d},{c}] {w_dtype}"
    assert torch.allclose(got["conf"], want["conf"], rtol=1e-4, atol=1e-6), \
        f"fused head conf {tag} max err {err}"
    assert torch.equal(got["pred"], want["pred"]), f"fused head pred {tag}"
    assert torch.equal(got["idx"], want["idx"]), f"fused head idx {tag}"
    k_ms = time_ms(lambda: fk.fused_head_gate(hd_, wd_, bd_, "max_softmax"),
                   samples=21, inner=3)
    def plain():
        logits = head_logits(hd_, wd_, bd_)
        return max_softmax(logits), logits.argmax(-1).int()

    p_ms = time_ms(plain, samples=21, inner=3)
    wbytes = wd_.element_size()
    bnd, by = bound(b * d * 4 + d * c * wbytes + c * 4 + b * 8,
                    2.0 * b * d * c, "fp32")
    row = {"kernel": "fused_head_gate", "shape": [[b, d], [d, c]],
           "dtype": f"hidden float32, w {str(w_dtype).split('.')[-1]}",
           "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
           "library_ms": None, "bound_ms": bnd, "bound_by": by}
    log(row)
    return row


def check_flash(dev, b: int, t: int, dtype, seed: int, window: int = 0,
                h: int = 32, kh: int = 4, hd: int = 128) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, t, n, hd)).astype(np.float32)).to(dev)
    q, k, v = mk(h).to(dtype), mk(kh).to(dtype), mk(kh).to(dtype)
    got = ak.flash_attention(q, k, v, causal=True, window=window)
    # plain version in f32 from the same (possibly bf16) inputs
    want = attention_ref(q.float(), k.float(), v.float(), causal=True,
                         window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tag = f"[{b},{t},{h},{hd}] {dtype} window={window}"
    assert got.dtype == dtype and got.shape == q.shape, tag
    assert err <= atol, f"flash attention {tag} max err {err} > {atol}"
    k_ms = time_ms(lambda: ak.flash_attention(q, k, v, causal=True,
                                              window=window),
                   samples=21, inner=3)
    p_ms = time_ms(lambda: attention_ref(q, k, v, causal=True, window=window),
                   samples=21, inner=3)
    lib_ms = None
    if not window:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), samples=21, inner=3)
    # visible (query, key) pairs under the causal / window mask
    tq = np.arange(t)
    lo = np.maximum(0, tq - window + 1) if window else np.zeros(t, int)
    pairs = float((tq - lo + 1).sum())
    esz = q.element_size()
    bnd, by = bound(esz * (2 * b * t * h * hd + 2 * b * t * kh * hd),
                    4.0 * b * h * hd * pairs,
                    "bf16" if dtype == torch.bfloat16 else "fp32")
    row = {"kernel": "flash_attention", "shape": [b, t, h, hd],
           "kv_heads": kh, "window": window,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "atol": atol, "kernel_ms": k_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by}
    log(row)
    return row


def kernel_phase(dev) -> dict:
    out = {"gate_path": check_gate(dev, 32, 8, seed=11),
           "gate_yi6b": check_gate(dev, 32, 64000, seed=12),
           "head_path": check_fused_head(dev, 32, 32, 8, torch.float32,
                                         seed=13),
           "head_yi6b": check_fused_head(dev, 32, 4096, 64000,
                                         torch.bfloat16, seed=14)}
    # 8 x 48: one transport window of escalations (max_in_flight 8) at
    # the task's 48 tokens, as the serve path sends it; 10 x 48: a whole
    # batch's escalations (ceil(0.3 * 32)); 1 x 2048: a long prompt
    out["flash_8x48_bfloat16"] = check_flash(dev, 8, 48, torch.bfloat16,
                                             seed=15)
    for b, t in ((10, 48), (1, 2048)):
        for dt in (torch.bfloat16, torch.float32):
            key = f"flash_{b}x{t}_{str(dt).split('.')[-1]}"
            out[key] = check_flash(dev, b, t, dt, seed=15)
    out["flash_window"] = check_flash(dev, 2, 300, torch.float32, seed=16,
                                      window=64)
    return out


# ----------------------------------------------------------------------------
# model and serve phases
# ----------------------------------------------------------------------------

def model_phase(dev) -> dict:
    """Reduced yi-6b prefill: the card (kernels) against the CPU (plain
    versions) on the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator("cpu").manual_seed(3))
    toks = np.random.default_rng(17).integers(1, cfg.vocab_size, (3, 40))
    with torch.no_grad():
        lc, cc = T.prefill(cfg, params, {"tokens": toks})
        lg, cg = T.prefill(cfg, tree_map(lambda a: a.to(dev), params),
                           {"tokens": toks})
    torch.cuda.synchronize()
    err = max(float((lg.cpu() - lc).abs().max()),
              float((cg["main"]["k"].cpu() - cc["main"]["k"]).abs().max()),
              float((cg["main"]["v"].cpu() - cc["main"]["v"]).abs().max()))
    row = {"phase": "model", "config": cfg.name, "max_abs_err": err,
           "atol": 1e-3}
    log(row)
    assert err <= 1e-3, f"reduced prefill card vs cpu: {err}"
    return row


def serve_checks(res, n: int) -> dict:
    from repro_torch.serving.engine import BILLING_FIELDS
    from repro_torch.serving.policy import REJECTED
    uids = sorted(r.uid for r in res.responses)
    assert uids == list(range(n)), f"answered {len(uids)} of {n} requests"
    st = res.engine.stats
    assert st.requests == n, (st.requests, n)
    per = st.per_backend.values()
    assert st.escalations == sum(u.remote_calls + u.cache_hits
                                 + u.transport_failures for u in per), \
        "billing: escalations != remote_calls + cache_hits + failures"
    assert st.escalations == st.remote_calls + st.cache_hits \
        + st.transport_failures
    assert math.isclose(st.total_cost, sum(u.cost for u in per),
                        rel_tol=1e-9, abs_tol=1e-12)
    assert all(np.isfinite(r.latency_s) for r in res.responses)
    backends = list(res.engine.router) if res.engine.router else []
    # the transport absorbs a failing remote_apply (a kernel that does not
    # build or launch included) into retries and the fallback answer:
    # every remote window must have succeeded at its first attempt
    assert st.transport_failures == 0, \
        f"{st.transport_failures} escalations lost to the transport"
    for b in backends:
        assert (b.stats.errors, b.stats.timeouts, b.stats.failed_requests,
                b.stats.short_circuited) == (0, 0, 0, 0), \
            f"backend {b.name}: {b.stats}"
    # so a fallback is only a billed remote answer that the 2nd supervisor
    # refused
    falls = [r for r in res.responses if r.source == "fallback"]
    assert all(r.disposition == REJECTED and r.cost > 0 for r in falls), \
        "a fallback answer that no remote call paid for"
    assert len(falls) == st.rejected, (len(falls), st.rejected)
    prefill_ms = [b.stats.mean_latency_s * 1e3 for b in backends
                  if b.stats.mean_latency_s is not None]
    return {"requests": n, "wall_s": res.wall_s,
            "req_per_s": n / res.wall_s,
            "remote_windows": sum(b.stats.windows for b in backends),
            "remote_prefill_ms_per_window": (prefill_ms[0] if prefill_ms
                                             else None),
            "billing": {f: getattr(st, f) for f in BILLING_FIELDS},
            "sources": {s: sum(r.source == s for r in res.responses)
                        for s in ("local", "remote", "fallback")}}


def routing_decided(rows, t_local: float | None, batch: int,
                    delta: float) -> None:
    """Raise unless moving every confidence by at most ``delta`` leaves
    each row's escalation as it is: no confidence within ``delta`` of
    ``t_local``, and in each window whose escalation capacity cut rows
    under ``t_local``, the escalated and the cut rows more than 2 delta
    apart. Windows are ``batch`` consecutive uids."""
    t = math.inf if t_local is None else t_local
    near = [r.uid for r in rows if abs(r.local_conf - t) <= delta]
    assert not near, f"confidences within {delta} of t_local: {near}"
    for w in sorted({r.uid // batch for r in rows}):
        win = [r for r in rows if r.uid // batch == w]
        esc = [r.local_conf for r in win if r.source != "local"]
        cut = [r.local_conf for r in win
               if r.source == "local" and r.local_conf < t]
        if esc and cut:
            assert min(cut) - max(esc) > 2 * delta, \
                f"window {w}: capacity cut within {2 * delta}"


def serve_phase(dev, argv=SERVE_ARGV) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_head_gate.ops import FusedLocalHead
    from repro_torch.launch import serve
    from repro_torch.models import surrogate as S
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    args = serve.parse_args(argv)
    stack = serve.build_stack(args)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    # full-width prefill output: finite, of the expected shapes
    with torch.no_grad():
        logits, cache = T.prefill(
            stack.rcfg, stack.rparams,
            {"tokens": stack.toks[:2] % stack.rcfg.vocab_size})
    rc = stack.rcfg
    assert logits.shape == (2, rc.vocab_size), logits.shape
    assert cache["main"]["k"].shape == (rc.num_layers, 2, stack.toks.shape[1],
                                        rc.num_kv_heads,
                                        rc.resolved_head_dim)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"

    # the main path: the window scheduler over the gated local step
    reset_launch_counts()
    res = serve.run(args, stack)
    torch.cuda.synchronize(dev)
    main_counts = launch_counts()
    main = serve_checks(res, args.requests)
    main["launches"] = main_counts
    for name in ("gate_score", "gate_select", "flash_attention"):
        assert main_counts[name] > 0, f"{name} never launched on the path"
    acc = np.mean([r.prediction == stack.labels[r.uid]
                   for r in res.responses if r.source != "fallback"])
    main["accepted_accuracy"] = float(acc)
    assert acc > 0.9, f"accepted accuracy {acc}"

    # the engine's other branch: a FusedLocalHead over the same surrogate
    @torch.no_grad()
    def trunk(tk):
        return S.apply(stack.scfg, stack.sparams, tk, return_hidden=True)[1]

    head = FusedLocalHead(trunk, stack.sparams["out"]["w"],
                          stack.sparams["out"]["b"])
    reset_launch_counts()
    res2 = serve.run(args, stack, local_apply=head, requests=FUSED_REQUESTS)
    torch.cuda.synchronize(dev)
    fused_counts = launch_counts()
    fused = serve_checks(res2, FUSED_REQUESTS)
    fused["launches"] = fused_counts
    for name in ("fused_head_gate", "gate_select", "flash_attention"):
        assert fused_counts[name] > 0, f"{name} never launched (fused head)"
    assert fused_counts["gate_score"] == 0
    # same surrogate, same requests: the two branches' confidences agree
    # within the kernels' tolerance, and where no decision of the main
    # run lies within that difference, they route alike
    head_rows = [r for r in res.responses if r.uid < FUSED_REQUESTS]
    conf_main = {r.uid: r.local_conf for r in head_rows}
    delta = max(abs(r.local_conf - conf_main[r.uid]) for r in res2.responses)
    fused["local_conf_max_abs_diff"] = delta
    assert delta <= CONF_TOL, f"fused vs main local conf differ by {delta}"
    routing_decided(head_rows, stack.cfg.t_local, args.batch, delta)
    first = {r.uid: (r.prediction, r.disposition) for r in head_rows}
    same = sum(first[r.uid] == (r.prediction, r.disposition)
               for r in res2.responses)
    fused["agree_with_main_path"] = same
    assert same == FUSED_REQUESTS, \
        f"fused head routed {FUSED_REQUESTS - same} requests differently"
    out = {"setup_s": setup_s, "main": main, "fused_head": fused,
           "remote": rc.name, "remote_layers": rc.num_layers,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log({"phase": "serve", **out})
    out["remote_window_profile"] = profile_remote_window(stack)
    return out


def profile_remote_window(stack, rows: int = 8, reps: int = 5) -> dict:
    """Where one remote transport window's time goes: its wall time
    unprofiled (median of ``reps``), then one run under torch.profiler
    for device (kernel) time by name and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": stack.toks[:rows] % stack.rcfg.vocab_size,
             "idx": np.arange(rows)}

    def window():
        stack.remote_apply(batch)
        torch.cuda.synchronize()

    window()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        window()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        traced_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v:
                return float(v)
        return 0.0

    # kernel events only (an operator's device time repeats its kernels')
    kern = sorted(((e.key, device_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and device_us(e) > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kern)
    row = {"phase": "remote_window_profile", "rows": rows,
           "tokens": int(batch["tokens"].shape[1]),
           "wall_ms": statistics.median(walls), "traced_wall_ms": traced_ms,
           "device_busy_ms": busy_ms if kern else None,
           "device_busy_share": busy_ms / traced_ms if kern else None,
           "top_kernels_ms": [[k, round(ms, 4), n] for k, ms, n in kern[:8]]}
    log(row)
    return row


# ----------------------------------------------------------------------------

SOURCES = {
    "gate_score": ("src/repro_torch/csrc/confidence_gate.cu",
                   "src/repro/kernels/confidence_gate/kernel.py:112"),
    "gate_select": ("src/repro_torch/csrc/confidence_gate.cu",
                    "src/repro/kernels/confidence_gate/kernel.py:129"),
    "fused_head_gate": ("src/repro_torch/csrc/fused_head_gate.cu",
                        "src/repro/kernels/fused_head_gate/kernel.py:41"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:31"),
}


def kernels_line(kern: dict, serve: dict) -> dict:
    """One entry per kernel at the shape the serving path gives it."""
    path_rows = {"gate_score": kern["gate_path"]["gate_score"],
                 "gate_select": kern["gate_path"]["gate_select"],
                 "fused_head_gate": kern["head_path"],
                 "flash_attention": kern["flash_8x48_bfloat16"]}
    launches = dict(serve["main"]["launches"])
    launches["fused_head_gate"] = serve["fused_head"]["launches"][
        "fused_head_gate"]
    out = []
    for name, row in path_rows.items():
        src, repl = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[name],
                    "max_abs_err": row["max_abs_err"],
                    "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "shape": row["shape"]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    # The plain versions and the model's projections must compute in full
    # fp32, as the reference's f32 dots do: TF32 keeps ~3 decimal digits
    # and would break the 1e-4 tolerances. Both switches are set, since
    # PyTorch defaults them differently.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    RESULTS["card"] = smi
    RESULTS["torch"] = [torch.__version__, torch.version.cuda]

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out_dir = build.build_all()
    RESULTS["build_s"] = time.perf_counter() - t0
    RESULTS["ptxas"] = {p.stem: sorted({ln.split(":", 1)[-1].strip()
                                        for ln in p.read_text().splitlines()
                                        if "registers" in ln})
                        for p in sorted(out_dir.glob("*.log"))}
    log({"phase": "build", "seconds": RESULTS["build_s"],
         "dir": str(out_dir.relative_to(ROOT)), "ptxas": RESULTS["ptxas"]})

    RESULTS["phases"]["kernels"] = kern = kernel_phase(dev)
    RESULTS["phases"]["model"] = model_phase(dev)
    RESULTS["phases"]["serve"] = serve = serve_phase(dev)
    line = kernels_line(kern, serve)
    RESULTS["kernels"] = line["kernels"]
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(smi.splitlines()[0], flush=True)
    log(line)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:   # report and fail: no result line on any failure
        traceback.print_exc()
        code = 1
    sys.exit(code)
