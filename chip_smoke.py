"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. In order, it

1. requires a CUDA device and prints the card's name and power limit;
2. builds every hand-written kernel from ``src/repro_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving and generate paths' shapes and at yi-6b's and rwkv6-1.6b's
   widths (and a 16384-token cache for decode attention, and MDSA at [256,
   4096] x [4096, 4096]), the attention kernels also at h2o-danube-1.8b's
   hd 80 (flash at [1, 4608] past a window of 4096; decode over its
   4096-slot ring), qwen2-7b's group of 7 and zamba2-7b's shared block
   (hd 112, MHA), and times kernel, plain
   version and (where one PyTorch call computes the same function) the
   library call with CUDA events, and every kernel's own device time and
   device kernels per call with torch.profiler (the wrapper's host work
   left out); maxconf at [32, 152064] and the gate's score at [32, 64000]
   are timed over copies of their logits larger than the L2; the gate's
   select also at [4096] and [12288] (k = B and 64, ties, +-0.0, +-inf, NaN
   and padding rows planted, exact), the fused head gate also with a bf16
   hidden state, and the head gate's confidence at the yi-6b head against
   float64;
4. checks the remote model's prefill and its decode steps on the card
   against the CPU on reduced configs of every family the port runs
   (yi-6b; qwen2-7b's QKV bias; deepseek-67b; h2o-danube, whose
   sliding-window ring buffer wraps, at hd 64 and widened to hd 80;
   deepseek-v2-lite's MLA and MoE after a dense layer; qwen3-moe's GQA
   and MoE; rwkv6; zamba2 in two groups at hd 64 and widened to hd 112;
   pixtral on patch embeddings and tokens; hubert's prefill on frame
   embeddings), then serves 256 requests through
   ``repro_torch.launch.serve`` with yi-6b at full width as the remote
   tier, and 64 more through an engine whose local tier is a
   ``FusedLocalHead`` over the same surrogate, asserting that every
   request is answered, that billing reconciles and that each kernel ran
   on those paths;
5. generates 32 tokens for 8 prompts of 512 tokens with the same yi-6b
   weights (``repro_torch.serving.greedy_generate``), asserting the
   decode-attention and maxconf launches on that run and that every
   decoded token is what a fresh prefill picks wherever its logit gap
   decides it; times the decode steps, profiles one, and applies the 2nd
   supervisor (``seq_min_likelihood``) to the answers;
6. mirrors ``benchmarks/supervisor_comparison.py`` on the card: trains a
   surrogate, fits MDSA on its training-set activations, scores the test
   set through the MDSA kernel and prints every supervisor's AUC-ROC;
7. frees yi-6b, then serves 256 requests with rwkv6-1.6b at full width
   as the remote tier (the RWKV6 scan kernel once per layer per remote
   window) and generates 32 tokens for 8 prompts of 512 tokens with it,
   with the checks of steps 4 and 5; then the same, one model at a time,
   each freed before the next, with qwen2-7b (flash attention once per
   layer per window, a group of 7), h2o-danube-1.8b (hd 80 through both
   attention kernels; also 32 tokens for 1 prompt of 4608, past its
   window of 4096: the prefill's rolled ring and decode over it),
   deepseek-v2-lite-16b (MLA and MoE in plain PyTorch: no attention
   kernel launches), zamba2-7b (both attention kernels at hd 112 once
   per group of its shared block, the mamba2 layers in plain PyTorch)
   and pixtral-12b (served on tokens; its prompts 256 patch embeddings,
   then 256 tokens);
8. frees the last of them, then holds the train path (``loss_fn``, every
   gradient leaf, the in-place AdamW step, a checkpoint round trip) on the
   card against the CPU on reduced yi-6b, h2o-danube (T = 128 past its
   window of 64), rwkv6, zamba2 in two groups, pixtral (the loss over
   the text only) and hubert (per-frame labels) in fp32
   (``train_parity``); trains yi-6b at full width through
   ``repro_torch.launch.train``'s own functions (batch 8 x 128, remat): a
   gradient for every leaf, 6 steps of its batch stream and 6 of one
   fixed batch whose loss must fall, no kernel launched, step time,
   tokens/s, MFU and peak memory (``train``); and the same for
   rwkv6-1.6b and hubert-xlarge (8 x 128 frame embeddings) at full
   width, 2 + 4 steps (``train_rwkv6``, ``train_hubert``);
9. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero without the last line. Full results are also
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
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
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}  # dense
SERVE_ARGV = ["--requests", "256", "--batch", "32", "--remote-budget", "0.3"]
FUSED_REQUESTS = 64
CONF_TOL = 1e-4        # the gate kernels' confidence tolerance (conf <= 1)
GEN_ROWS, GEN_PROMPT, GEN_TOKENS = 8, 512, 32   # the generate phase
RWKV_ARCH = "rwkv6-1.6b"
# the other archs served and generated at full width, one at a time
FULL_WIDTH_ARCHS = ("qwen2-7b", "h2o-danube-1.8b", "deepseek-v2-lite-16b",
                    "zamba2-7b", "pixtral-12b")
LONG_PROMPT = 4608     # h2o-danube's 1-row generate, past its 4096 window
VLM_ARCH, AUDIO_ARCH = "pixtral-12b", "hubert-xlarge"
# pixtral's generate prompts: GEN_PATCHES patch embeddings, then
# GEN_PROMPT - GEN_PATCHES tokens
GEN_PATCHES = 256
# The decode and prefill paths round their bf16 activations at different
# places: their logits may differ by at most GEN_LOGIT_TOL[arch] (2.5x
# the largest difference measured on an H100: yi-6b 0.10, rwkv6-1.6b
# 0.227, qwen2-7b and h2o-danube-1.8b 0.094), and a decoded token is
# checked against a fresh prefill wherever that prefill's top-2 gap
# exceeds DECISIVE_GAP[arch] (the tolerance itself where none is given).
# rwkv6's prefill top-2 gaps are smaller (median 0.16, 90th percentile
# 0.5), so only ~8% of its tokens clear 0.6: the floor on how many are
# checked is a 32nd of them (an 8th for the others).
# deepseek-v2-lite routes each token to 6 of its 64 experts, and those
# rounding differences change that choice between decode and prefill
# (``moe_route_flips`` counts the (step, layer, row)s): its logits differ
# by up to 1.10 (median 0.29 over the steps and rows, measured on an
# H100). Its tokens are checked where the prefill's top-2 gap exceeds
# 0.5 (25 of 256 measured, all agreeing), with a floor of a 16th.
# pixtral-12b's logits differ by up to 0.148 and zamba2-7b's by up to
# 0.52 (median 0.42, at every 4th step: 81 layers of bf16 activations
# feeding the fp32 mamba2 recurrence), with prefill top-2 gaps of median
# 0.16-0.17 and 90th percentile 0.44-0.54 (measured on an H100).
# zamba2's logit bound is 1.5, and its tokens are checked where the gap
# exceeds 0.6, above any difference measured, with a floor of a 32nd.
# Its prefill runs the per-token mamba2 loop (a few launches a token a
# layer), so its fresh prefills are made at every PREFILL_STRIDE-th
# step only
GEN_LOGIT_TOL = {"yi-6b": 0.25, RWKV_ARCH: 0.6, "qwen2-7b": 0.25,
                 "h2o-danube-1.8b": 0.25, "deepseek-v2-lite-16b": 2.75,
                 "zamba2-7b": 1.5, VLM_ARCH: 0.375}
DECISIVE_GAP = {"deepseek-v2-lite-16b": 0.5, "zamba2-7b": 0.6}
CHECKED_FLOOR = {RWKV_ARCH: 32, "deepseek-v2-lite-16b": 16,
                 "zamba2-7b": 32, VLM_ARCH: 16}
PREFILL_STRIDE = {"zamba2-7b": 4}
HD80 = "h2o-danube-1.8b@hd80"   # reduced h2o-danube widened to hd 80
# reduced zamba2 in 2 groups of 2 mamba2 layers, at hd 64 and at hd 112
ZAMBA2G, ZAMBA112 = "zamba2-7b@2groups", "zamba2-7b@hd112"
# the RWKV6 scan against its plain version in f32 on the same inputs:
# |got - want| <= RWKV_TOL * max|want| + 1e-5 (fp32 sums of M products in
# another order and FMA contraction in the state update, a few ulp per
# step)
RWKV_TOL = 2e-5
MDSA_RTOL = 1e-4       # fp32 quadratic forms summed in another order
# decode attention vs its plain version in f32 on the same inputs:
# |got - want| <= rtol * |want| + atol. bf16: one rounding of the output
# (at most 2^-8 relative), and atol for the fp32 sums; the limit shrinks
# with the output, which a softmax over a long cache makes small
DECODE_TOL = {torch.bfloat16: (2.0 ** -8, 1e-3), torch.float32: (0.0, 1e-4)}
# the train path, card vs CPU in fp32 (the CPU tests' tolerances against
# JAX): loss rtol 1e-5; a gradient leaf within GRAD_TOL * max|g| + 1e-7
# (rwkv6's leaves that feed r and k amplify the matmuls' fp32 rounding
# about 1e4-fold, tests/test_torch_train.py); an AdamW step from the same
# gradients within 1e-6 (params) and rtol 1e-5 (moments)
GRAD_TOL = {"yi-6b": 1e-4, "h2o-danube-1.8b": 1e-4, RWKV_ARCH: 2e-3,
            ZAMBA2G: 1e-4, VLM_ARCH: 1e-4, AUDIO_ARCH: 1e-4}
TRAIN_SEQ = 128       # launcher defaults: batch 8 x 128 tokens, remat
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


def _device_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v:
            return float(v)
    return 0.0


def _is_kernel(e) -> bool:
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and _device_us(e) > 0)


def device_ms(fn, marks: tuple[str, ...],
              calls: int = 20) -> tuple[float | None, int]:
    """(device time of one call of ``fn``, device kernels per call):
    ``calls`` back-to-back calls run under torch.profiler; each kernel
    whose name contains one of ``marks`` counts its mean time per launch
    once for each launch per call, and every device kernel of any name
    counts towards the launches per call. The wrapper's host work is not
    in it (it is in the CUDA-event times, where it sets the pace at small
    shapes). The profiler drops an event now and then (37 of 40 once, at
    1.3 ms kernels), so launches per call are rounded, and it has come
    back empty, so an empty trace is taken once more; the time is None
    where the second one records no device time either."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if _is_kernel(e)]
        us = sum(_device_us(e) / e.count * round(e.count / calls)
                 for e in kern if any(m in e.key for m in marks))
        if us:
            return us / 1e3, round(sum(e.count for e in kern) / calls)
    return None, 0


# the gate family's kernels as built: the profiler marks naming them and
# the device kernels one call runs. A mark naming no kernel that is built
# measures nothing, so the count is checked and a count of 0 fails
DEVICE_KERNELS = {
    "gate_score": (("vocab_stats_kernel",), 1),
    "gate_select": (("gate_select_warp_kernel", "gate_select_sort_kernel"),
                    1),
    "fused_head_gate": (("head_gate_narrow_kernel", "head_gate_mma_kernel",
                         "head_gate_fma_kernel"), 1),
    "maxconf": (("vocab_stats_kernel",), 1),
}


def profiled(name: str, fn) -> dict:
    """Device time and kernels per call of ``fn``, one call of kernel
    ``name``'s wrapper; raises unless the profiler saw exactly the
    kernels that ``name`` is built from."""
    marks, want = DEVICE_KERNELS[name]
    ms, per_call = device_ms(fn, marks)
    assert ms and per_call == want, \
        f"{name}: {per_call} device kernels per call under {marks} " \
        f"(device time {ms}), expected {want}"
    return {"device_ms": ms, "device_kernels_per_call": per_call}


L2_BYTES = 50e6                   # H100 SXM L2 cache


def cold_copies(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` and copies of it, together at least twice the L2: a call
    cycling through them reads its input from device memory."""
    n = max(2, math.ceil(2 * L2_BYTES / (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def amax_yardstick(inputs: list) -> float | None:
    """Device time of torch.amax over the rows of ``inputs``, cycled as
    the kernel's timing cycles them: one PyTorch reduction reading the
    same bytes (not the same function: no library_ms)."""
    return device_ms(cycling(lambda t: torch.amax(t, 1), inputs), ("",))[0]


def cycling(fn, inputs: list):
    """A thunk calling ``fn`` on the next of ``inputs`` each time."""
    nxt = itertools.cycle(inputs).__next__
    return lambda: fn(nxt())


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

def check_gate(dev, b: int, c: int, seed: int, cold: bool = False) -> dict:
    """The gate's score and select at [B, C] f32 against their plain
    versions; with ``cold`` the score is timed over copies of the logits
    larger than the L2 (on the serve path the logits arrive fresh from
    the local head and are timed back to back)."""
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
    inputs = cold_copies(logits) if cold else [logits]
    score = cycling(lambda lg: gk.gate_score(lg, "max_softmax"), inputs)
    score_ms = time_ms(score)
    score_dev = profiled("gate_score", score)
    score_plain = time_ms(lambda: (max_softmax(logits),
                                   logits.argmax(-1).int()))
    conf = got["conf"]
    select_ms = time_ms(lambda: gk.gate_select(conf, tt, nn, b))
    select_dev = profiled("gate_select",
                          lambda: gk.gate_select(conf, tt, nn, b))
    select_plain = time_ms(lambda: select_ref(conf, tt, nn, b))
    sb, sby = bound(b * c * 4 + b * 8, 6.0 * b * c, "fp32")
    lb, lby = bound(b * 4 + 8 + b * 4, 4.0 * b * b, "fp32")
    rows = [
        {"kernel": "gate_score", "shape": [b, c], "dtype": "float32",
         "max_abs_err": err, "kernel_ms": score_ms, **score_dev,
         "cold_l2_copies": len(inputs) if cold else None,
         "amax_device_ms": amax_yardstick(inputs) if cold else None,
         "plain_ms": score_plain, "library_ms": None, "bound_ms": sb,
         "bound_by": sby},
        {"kernel": "gate_select", "shape": [b], "dtype": "float32",
         "max_abs_err": float((got["idx"] - want["idx"]).abs().max()),
         "kernel_ms": select_ms, **select_dev, "plain_ms": select_plain,
         "library_ms": None, "bound_ms": lb, "bound_by": lby},
    ]
    for r in rows:
        log(r)
        not_below_bound(r)
    return {r["kernel"]: r for r in rows}


def planted_conf(rng, b: int) -> np.ndarray:
    """Confidences in [0, 1) with the select's edge cases planted: ties
    (a value repeated across rows), -0.0 beside +0.0, +inf, -inf and NaN
    rows."""
    c = rng.random(b).astype(np.float32)
    rows = rng.permutation(b)
    c[rows[:b // 16]] = c[rows[b // 16]]                 # ties
    c[rows[b // 16 + 1:b // 16 + 4]] = 0.0
    c[rows[b // 16 + 4:b // 16 + 7]] = -0.0
    c[rows[b // 16 + 7:b // 16 + 10]] = np.inf
    c[rows[b // 16 + 10:b // 16 + 13]] = np.nan
    c[rows[b // 16 + 13:b // 16 + 15]] = -np.inf
    return c


def check_select(dev, b: int, k: int, seed: int) -> dict:
    """gate_select at [B] (the sort form) against select_ref, exactly, on
    planted ties, +-0.0, +-inf and NaN, with padding rows (n_valid < B)
    and a threshold that cuts the eligible rows; library: torch.topk of
    the masked confidences (no threshold, no promised tie order: a
    yardstick only)."""
    from repro_torch.kernels.confidence_gate import kernel as gk
    from repro_torch.kernels.confidence_gate.ref import select_ref
    rng = np.random.default_rng(seed)
    conf = torch.from_numpy(planted_conf(rng, b)).to(dev)
    n_valid = b - b // 10
    nn = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    for t in (0.5, 0.0, math.inf):
        tt = torch.tensor(t, dtype=torch.float32, device=dev)
        got = gk.gate_select(conf, tt, nn, k)
        want = select_ref(conf, tt, nn, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"gate_select [{b}] k {k} t {t}: first differences at " \
            f"{(got != want).nonzero()[:4].flatten().tolist()}"
    tt = torch.tensor(0.5, dtype=torch.float32, device=dev)
    call = lambda: gk.gate_select(conf, tt, nn, k)  # noqa: E731
    rows = torch.arange(b, device=dev)
    masked = torch.where(rows < n_valid, conf, math.inf)
    nbytes = b * 4 + 8 + k * 4
    bnd, by = bound(nbytes, b * math.log2(b), "fp32")
    row = {"kernel": "gate_select", "shape": [b], "k": k, "dtype": "float32",
           "max_abs_err": 0.0, "kernel_ms": time_ms(call), **profiled(
               "gate_select", call),
           "plain_ms": time_ms(lambda: select_ref(conf, tt, nn, k)),
           "library_ms": time_ms(lambda: torch.topk(masked, k,
                                                    largest=False)),
           "library": "torch.topk(masked, k, largest=False)",
           "bound_ms": bnd, "bound_by": by}
    log(row)
    not_below_bound(row)
    return row


def check_fused_head(dev, b: int, d: int, c: int, w_dtype, seed: int,
                     h_dtype=torch.float32) -> dict:
    """The fused head gate at [B, D] x [D, C] against its plain version
    (conf rtol 1e-4 / atol 1e-6, pred and idx exact), and conf's error
    against a float64 computation on the same inputs for the kernel and
    the plain version, as a share of that limit (bounded by it). Bound:
    bytes, or the operations of the kernel's form (bf16 w: three bf16
    tensor-core products for an f32 hidden, one for bf16; f32 w: fp32),
    with the fp32 CUDA-core figure beside it; library (bf16 w): one
    cuBLAS addmm of the bf16 hidden, w and bias, a byte yardstick (not
    the same function)."""
    from repro_torch.kernels.fused_head_gate import kernel as fk
    from repro_torch.kernels.fused_head_gate import ops as fops
    from repro_torch.kernels.fused_head_gate.ref import (fused_head_gate_ref,
                                                         head_logits)
    from repro_torch.core.supervisors import max_softmax
    n_valid = b - 3
    for s in range(seed, seed + 20):
        rng = np.random.default_rng(s)
        h = rng.standard_normal((b, d)).astype(np.float32)
        if h_dtype == torch.bfloat16:
            h = torch.from_numpy(h).bfloat16().float().numpy()
        w = (rng.standard_normal((d, c), dtype=np.float32)
             / np.float32(math.sqrt(d)))
        if c > 64:
            # plant a large logit for each row: w[:, c_r] += m_r h_r/|h_r|^2
            cols = rng.choice(c, b, replace=False)
            m = 8.0 + 0.25 * rng.permutation(b)
            w[:, cols] += (h / (h * h).sum(1, keepdims=True)
                           * m[:, None]).T.astype(np.float32)
        bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
        hd_, wd_ = torch.from_numpy(h).to(dev).to(h_dtype), \
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
    tag = f"[{b},{d}]x[{d},{c}] {h_dtype} x {w_dtype}"
    assert torch.allclose(got["conf"], want["conf"], rtol=1e-4, atol=1e-6), \
        f"fused head conf {tag} max err {err}"
    assert torch.equal(got["pred"], want["pred"]), f"fused head pred {tag}"
    assert torch.equal(got["idx"], want["idx"]), f"fused head idx {tag}"
    # conf against float64 on the same inputs, as a share of the limit
    logits64 = hd_.double() @ wd_.double() + bd_.double()
    conf64 = torch.softmax(logits64, -1).max(-1).values
    del logits64
    vs64 = {name: float(((v.double() - conf64).abs()
                         / (1e-4 * conf64.abs() + 1e-6)).max())
            for name, v in (("kernel", got["conf"]), ("plain", want["conf"]))}
    assert vs64["kernel"] <= 1, f"fused head {tag}: conf vs float64 " \
        f"{vs64['kernel']:.3f} of rtol 1e-4 / atol 1e-6"

    def head():
        return fk.fused_head_gate(hd_, wd_, bd_, "max_softmax")

    k_ms = time_ms(head, samples=21, inner=3)
    head_dev = profiled("fused_head_gate", head)

    def plain():
        logits = head_logits(hd_, wd_, bd_)
        return max_softmax(logits), logits.argmax(-1).int()

    p_ms = time_ms(plain, samples=21, inner=3)
    lib_ms = None
    if w_dtype == torch.bfloat16:
        hb, bb = hd_.bfloat16(), bd_.bfloat16()
        lib_ms = time_ms(lambda: torch.addmm(bb, hb, wd_), samples=21,
                         inner=3)
    nbytes = (b * d * hd_.element_size() + d * c * wd_.element_size()
              + c * 4 + b * 8)
    flops = 2.0 * b * d * c
    pieces = 1 if h_dtype == torch.bfloat16 else 3
    bnd, by = (bound(nbytes, pieces * flops, "bf16")
               if w_dtype == torch.bfloat16 else bound(nbytes, flops, "fp32"))
    row = {"kernel": "fused_head_gate", "shape": [[b, d], [d, c]],
           "dtype": f"hidden {str(h_dtype).split('.')[-1]}, "
                    f"w {str(w_dtype).split('.')[-1]}",
           "form": fk.head_plan(b, d, c, hd_.dtype, wd_.dtype,
                                wd_.data_ptr() % 16 == 0).form,
           "max_abs_err": err, "share_of_limit_vs_float64": vs64,
           "kernel_ms": k_ms, **head_dev,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "library": "addmm(bias, hidden, w) in bf16" if lib_ms else None,
           "bound_ms": bnd, "bound_by": by,
           "bound_fp32_cuda_core_ms": bound(nbytes, flops, "fp32")[0]}
    log(row)
    not_below_bound(row)
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
    tag = f"[{b},{t},{h}/{kh},{hd}] {dtype} window={window}"
    assert got.dtype == dtype and got.shape == q.shape, tag
    assert err <= atol, f"flash attention {tag} max err {err} > {atol}"
    k_ms = time_ms(lambda: ak.flash_attention(q, k, v, causal=True,
                                              window=window),
                   samples=21, inner=3)
    dev_ms, dev_n = device_ms(
        lambda: ak.flash_attention(q, k, v, causal=True, window=window),
        ("flash_wgmma_kernel", "flash_prefill_kernel"))
    p_ms = time_ms(lambda: attention_ref(q, k, v, causal=True, window=window),
                   samples=21, inner=3)
    # yardstick: SDPA over the [B, H, T, hd] views; under a window with
    # a boolean mask of the visible (query, key) pairs
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if window:
        pos = torch.arange(t, device=dev)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=not window, enable_gqa=True),
        samples=21, inner=3)
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
           "atol": atol, "kernel_ms": k_ms, "device_ms": dev_ms,
           "device_kernels_per_call": dev_n,
           "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bnd,
           "bound_by": by}
    log(row)
    return row


def check_decode(dev, b: int, s: int, dtype, seed: int, lens=None,
                 h: int = 32, kh: int = 4, hd: int = 128) -> dict:
    """Decode attention at [B, S, K, hd] caches with per-row ``lens``
    (default: every slot valid) against the plain version in f32."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, hd), np.float32))
    q = q.to(dev).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kh, hd), np.float32))
            .to(dev).to(dtype) for _ in range(2))
    lens = [s] * b if lens is None else list(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = dk.decode_attention(q, k, v, kv_len)
    want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    rtol, atol = DECODE_TOL[dtype]
    tag = f"[{b},{s},{kh},{hd}] h={h} {dtype} lens {min(lens)}..{max(lens)}"
    assert got.dtype == dtype and got.shape == q.shape, tag
    used = float((diff / (rtol * want.abs() + atol)).max())
    assert used <= 1, \
        f"decode attention {tag} max err {err} exceeds {rtol}|want| + {atol}"
    k_ms = time_ms(lambda: dk.decode_attention(q, k, v, kv_len))
    dev_ms, dev_n = device_ms(lambda: dk.decode_attention(q, k, v, kv_len),
                              ("decode_split_kernel", "decode_combine_kernel"))
    p_ms = time_ms(lambda: decode_attention_ref(q, k, v, kv_len))
    # yardstick: SDPA over the [B, K, S, hd] view with the kv_len mask
    mask = (torch.arange(s, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    valid = float(sum(lens))
    esz = q.element_size()
    bnd, by = bound(esz * (2 * b * h * hd + 2 * valid * kh * hd) + 4 * b,
                    4.0 * h * hd * valid,
                    "bf16" if dtype == torch.bfloat16 else "fp32")
    row = {"kernel": "decode_attention", "shape": [b, s, kh, hd],
           "heads": h, "kv_len": [min(lens), max(lens)],
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "rtol": rtol, "atol": atol, "share_of_limit": used,
           "kernel_ms": k_ms, "device_ms": dev_ms,
           "device_kernels_per_call": dev_n, "plain_ms": p_ms,
           "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by}
    log(row)
    return row


def check_maxconf(dev, b: int, v: int, seed: int, cold: bool = False) -> dict:
    """maxconf at [B, V] f32 with planted maxima (and, on every other
    row, a planted tie at a later column: the first index must win).
    With ``cold`` it is timed over copies of the logits larger than the
    L2 (on the generate path the logits arrive fresh from the head GEMM
    and are timed back to back)."""
    from repro_torch.kernels.maxconf import kernel as mk
    from repro_torch.kernels.maxconf.ref import maxconf_ref
    rng = np.random.default_rng(seed)
    x = planted_logits(rng, b, v)
    top = x.argmax(1)
    for r in range(0, b, 2):
        later = int(rng.integers(top[r] + 1, v)) if top[r] + 1 < v else top[r]
        x[r, later] = x[r, top[r]]
    logits = torch.from_numpy(x).to(dev)
    got = mk.maxconf(logits)
    want = maxconf_ref(logits)
    torch.cuda.synchronize()
    tag = f"[{b},{v}]"
    assert torch.equal(got["prediction"], want["prediction"]), \
        f"maxconf prediction {tag}"
    assert torch.equal(got["prediction"].cpu(),
                       torch.from_numpy(top.astype(np.int32))), \
        f"maxconf first-index ties {tag}"
    errs = {key: float((got[key] - want[key]).abs().max())
            for key in ("max_softmax", "pcs", "entropy")}
    # max_softmax and pcs: fp32 sums in another order; entropy is
    # m1 + log s - t/s, a difference of terms as large as the top logit
    tols = {"max_softmax": 1e-5, "pcs": 1e-5,
            "entropy": 2e-6 * float(np.abs(x).max()) + 1e-5}
    for key, e in errs.items():
        assert e <= tols[key], f"maxconf {key} {tag} max err {e}"
    inputs = cold_copies(logits) if cold else [logits]
    call = cycling(mk.maxconf, inputs)
    k_ms = time_ms(call)
    k_dev = profiled("maxconf", call)
    p_ms = time_ms(lambda: maxconf_ref(logits))
    bnd, by = bound(b * v * 4 + b * 16, 6.0 * b * v, "fp32")
    row = {"kernel": "maxconf", "shape": [b, v], "dtype": "float32",
           "max_abs_err": max(errs.values()), "errs": errs, "atol": tols,
           "kernel_ms": k_ms, **k_dev,
           "cold_l2_copies": len(inputs) if cold else None,
           "amax_device_ms": amax_yardstick(inputs) if cold else None,
           "plain_ms": p_ms, "library_ms": None, "bound_ms": bnd,
           "bound_by": by}
    log(row)
    not_below_bound(row)
    return row


def scan_inputs(dev, b: int, t: int, h: int, m: int, dtype, seed: int):
    """r, k, v (dtype) at scale 0.5; w = exp(-exp(n - 3)) in (0, 1), from
    fast to slow decay as the model's data-dependent decay spreads it;
    u, s0 f32 (a carried state)."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, scale, dt: (torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(shape)).astype(np.float32))
        .to(dev).to(dt))
    shape = (b, t, h, m)
    r, k, v = (mk(shape, 0.5, dtype) for _ in range(3))
    w = torch.exp(-torch.exp(mk(shape, 1.0, torch.float32) - 3.0))
    return r, k, v, w, mk((h, m), 0.5, torch.float32), \
        mk((b, h, m, m), 0.5, torch.float32)


def scan_err(got, want) -> tuple[float, float]:
    """(max abs error over y and s_T, its share of the limit
    RWKV_TOL * max|want| + 1e-5, per output)."""
    errs, used = [], []
    for g, x in zip(got, want):
        e = float((g - x).abs().max())
        errs.append(e)
        used.append(e / (RWKV_TOL * float(x.abs().max()) + 1e-5))
    return max(errs), max(used)


def check_rwkv6_scan(dev, b: int, t: int, h: int, m: int, dtype,
                     seed: int, aliased: bool = False) -> dict:
    """The scan at [B, T, H, M] against its plain version in f32 on the
    same inputs; ``aliased`` passes s0 as s_out too (decode's in-place
    state update)."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    r, k, v, w, u, s0 = scan_inputs(dev, b, t, h, m, dtype, seed)
    want = rwkv6_scan_ref(r.float(), k.float(), v.float(), w, u, s0)
    if aliased:
        state = s0.clone()
        y, s_t = rk.rwkv6_scan(r, k, v, w, u, state, state)
        assert s_t.data_ptr() == state.data_ptr()
    else:
        y, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    err, used = scan_err((y, s_t), want)
    tag = f"[{b},{t},{h},{m}] {dtype} aliased={aliased}"
    assert used <= 1, f"rwkv6 scan {tag} max err {err} ({used:.2f} of limit)"
    out = torch.empty_like(s0)
    k_ms = time_ms(lambda: rk.rwkv6_scan(r, k, v, w, u, s0, out),
                   samples=21, inner=3 if t > 64 else 10)
    dev_ms, dev_n = device_ms(lambda: rk.rwkv6_scan(r, k, v, w, u, s0, out),
                              ("rwkv6_scan_kernel",))
    p_ms = time_ms(lambda: rwkv6_scan_ref(r, k, v, w, u, s0), samples=21,
                   inner=1, warmup=2)
    n_tok = b * t * h
    esz = r.element_size()
    bnd, by = bound(n_tok * m * (3 * esz + 4 + 4) + 4 * h * m
                    + 2 * 4 * b * h * m * m,
                    n_tok * (4.0 * m * m + 5.0 * m), "fp32")
    row = {"kernel": "rwkv6_scan", "shape": [b, t, h, m],
           "dtype": f"r/k/v {str(dtype).split('.')[-1]}, w/u/state float32",
           "aliased_state": aliased, "max_abs_err": err,
           "share_of_limit": used, "rtol_of_max": RWKV_TOL,
           "kernel_ms": k_ms, "device_ms": dev_ms,
           "device_kernels_per_call": dev_n, "plain_ms": p_ms,
           "library_ms": None, "bound_ms": bnd, "bound_by": by}
    log(row)
    not_below_bound(row)
    return row


def check_rwkv6_carry(dev) -> dict:
    """Scanning a GEN_PROMPT-token sequence in three pieces (the middle one
    a single token) with the state carried in place equals scanning the
    whole, both on the kernel."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    r, k, v, w, u, s0 = scan_inputs(dev, 8, GEN_PROMPT, 32, 64,
                                    torch.bfloat16, seed=31)
    y_full, s_full = rk.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    cut = GEN_PROMPT * 2 // 5
    ys = [rk.rwkv6_scan(*(z[:, a:e].contiguous() for z in (r, k, v, w)), u,
                        state, state)[0]
          for a, e in ((0, cut), (cut, cut + 1), (cut + 1, GEN_PROMPT))]
    torch.cuda.synchronize()
    err, used = scan_err((torch.cat(ys, 1), state), (y_full, s_full))
    row = {"kernel": "rwkv6_scan", "check": "state carry, 3 pieces vs whole",
           "shape": [8, GEN_PROMPT, 32, 64], "max_abs_err": err,
           "share_of_limit": used}
    log(row)
    assert used <= 1, f"rwkv6 scan state carry: max err {err}"
    return row


def check_mdsa(dev, b: int, d: int, seed: int) -> dict:
    """MDSA distance at [B, D] x [D, D] (P symmetric positive definite)
    against its plain version with TF32 off; library: one einsum on
    y = x - mu. The bound is the least time for an fp32-accurate result
    on this card, three TF32 tensor-core products (3xTF32, as the kernel
    computes); the fp32 CUDA-core figure is kept beside it."""
    from repro_torch.kernels.mdsa import kernel as mk
    from repro_torch.kernels.mdsa.ref import mdsa_ref
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((d, d), np.float32)).to(dev)
    prec = (a @ a.T) * (0.09 / d) + torch.eye(d, device=dev)
    del a
    x = torch.from_numpy(rng.standard_normal((b, d), np.float32)).to(dev)
    mean = torch.from_numpy(
        (0.3 * rng.standard_normal(d)).astype(np.float32)).to(dev)
    got = mk.mdsa(x, mean, prec)
    want = mdsa_ref(x, mean, prec)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    used = float(((got - want).abs() / (MDSA_RTOL * want.abs()
                                        + MDSA_RTOL)).max())
    tag = f"[{b},{d}]x[{d},{d}]"
    assert got.shape == (b,) and used <= 1, \
        f"mdsa {tag} max err {err} ({used:.2f} of the limit)"
    # the kernel's and the plain version's error against float64, on the
    # same limit: which of the two the error against each other is
    y64 = x.double() - mean.double()
    want64 = torch.einsum("bd,de,be->b", y64, prec.double(), y64)
    want64 = torch.sqrt(torch.clamp(want64, min=0.0))
    vs64 = {name: float(((v.double() - want64).abs()
                         / (MDSA_RTOL * want64.abs() + MDSA_RTOL)).max())
            for name, v in (("kernel", got), ("plain", want))}
    inner = 3 if d >= 1024 else 10
    k_ms = time_ms(lambda: mk.mdsa(x, mean, prec), samples=21, inner=inner)
    dev_ms, dev_n = device_ms(lambda: mk.mdsa(x, mean, prec),
                              ("mdsa_partial_kernel", "mdsa_finish_kernel"))
    p_ms = time_ms(lambda: mdsa_ref(x, mean, prec), samples=21, inner=inner)
    y = x - mean
    lib_ms = time_ms(lambda: torch.einsum("bd,de,be->b", y, prec, y),
                     samples=21, inner=inner)
    nbytes = 4.0 * (b * d + d + d * d + b)
    bnd, by = bound(nbytes, 3 * 2.0 * b * d * d, "tf32")
    row = {"kernel": "mdsa", "shape": [[b, d], [d, d]], "dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "max_abs_err": err, "rtol": MDSA_RTOL, "atol": MDSA_RTOL,
           "share_of_limit": used, "share_of_limit_vs_float64": vs64,
           "kernel_ms": k_ms, "device_ms": dev_ms,
           "device_kernels_per_call": dev_n,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "library": "einsum bd,de,be->b on x - mu",
           "bound_ms": bnd, "bound_by": by,
           "bound_fp32_cuda_core_ms": bound(
               nbytes, 2.0 * b * d * d + 3.0 * b * d, "fp32")[0]}
    log(row)
    not_below_bound(row)
    return row


def not_below_bound(row: dict) -> None:
    """No time may read faster than the least time the card could take:
    that would be a wrong bound or a kernel that skipped work."""
    for key in ("kernel_ms", "device_ms"):
        if row.get(key) is not None:
            assert row[key] >= row["bound_ms"], \
                f"{row['kernel']} {row['shape']}: {key} {row[key]} below " \
                f"its bound {row['bound_ms']}"


def kernel_phase(dev) -> dict:
    out = {"gate_path": check_gate(dev, 32, 8, seed=11),
           "gate_yi6b": check_gate(dev, 32, 64000, seed=12, cold=True),
           "head_path": check_fused_head(dev, 32, 32, 8, torch.float32,
                                         seed=13),
           "head_yi6b": check_fused_head(dev, 32, 4096, 64000,
                                         torch.bfloat16, seed=14),
           "head_yi6b_bf16_hidden": check_fused_head(
               dev, 32, 4096, 64000, torch.bfloat16, seed=14,
               h_dtype=torch.bfloat16)}
    # the select's sort form at B = 4096 and 12288, k = B and 64
    for b in (4096, 12288):
        for k in (b, 64):
            out[f"select_{b}_k{k}"] = check_select(dev, b, k, seed=b + k)
    # 8 x 48: one transport window of escalations (max_in_flight 8) at
    # the task's 48 tokens, as the serve path sends it; 10 x 48: a whole
    # batch's escalations (ceil(0.3 * 32)); 8 x 512: the generate path's
    # prefill; 1 x 2048: a long prompt
    out["flash_8x48_bfloat16"] = check_flash(dev, 8, 48, torch.bfloat16,
                                             seed=15)
    out["flash_8x512_bfloat16"] = check_flash(dev, GEN_ROWS, GEN_PROMPT,
                                              torch.bfloat16, seed=17)
    for b, t in ((10, 48), (1, 2048)):
        for dt in (torch.bfloat16, torch.float32):
            key = f"flash_{b}x{t}_{str(dt).split('.')[-1]}"
            out[key] = check_flash(dev, b, t, dt, seed=15)
    for dt in (torch.bfloat16, torch.float32):
        out[f"flash_window_{str(dt).split('.')[-1]}"] = check_flash(
            dev, 2, 300, dt, seed=16, window=64)
    # decode attention: the generate path's last step (8 prompts of 512
    # tokens + 31 decoded: 543 valid of 544 slots), per-row lengths, a
    # full 64-slot ring buffer and a long context
    s_path = GEN_PROMPT + GEN_TOKENS
    for dt in (torch.bfloat16, torch.float32):
        out[f"decode_path_{str(dt).split('.')[-1]}"] = check_decode(
            dev, GEN_ROWS, s_path, dt, seed=18, lens=[s_path - 1] * GEN_ROWS)
    out["decode_ragged"] = check_decode(
        dev, 8, s_path, torch.bfloat16, seed=19,
        lens=[1, s_path, 100, 272, 400, 7, s_path - 1, 33])
    out["decode_ring64"] = check_decode(dev, 8, 64, torch.bfloat16, seed=20)
    out["decode_long"] = check_decode(dev, 8, 16384, torch.bfloat16, seed=21)
    # f32 at the same length: twice the bytes through the CUDA-core scores
    out["decode_long_float32"] = check_decode(dev, 8, 16384, torch.float32,
                                              seed=21)
    # h2o-danube-1.8b's shapes, hd 80 (32 heads over 8): a serve window,
    # the generate prefill, the 1 x 4608 prompt past its window of 4096;
    # decode over 544 slots and over the full 4096-slot ring at B = 1
    h2o = {"h": 32, "kh": 8, "hd": 80}
    for b, t, window, dt in ((8, 48, 4096, torch.bfloat16),
                             (GEN_ROWS, GEN_PROMPT, 4096, torch.bfloat16),
                             (1, LONG_PROMPT, 4096, torch.bfloat16),
                             (8, 48, 4096, torch.float32),
                             (2, 300, 64, torch.float32)):
        key = f"flash_h2o_{b}x{t}_w{window}_{str(dt).split('.')[-1]}"
        out[key] = check_flash(dev, b, t, dt, seed=t, window=window, **h2o)
    for dt in (torch.bfloat16, torch.float32):
        out[f"decode_h2o_path_{str(dt).split('.')[-1]}"] = check_decode(
            dev, GEN_ROWS, s_path, dt, seed=32, lens=[s_path - 1] * GEN_ROWS,
            **h2o)
    out["decode_h2o_ring4096"] = check_decode(dev, 1, 4096, torch.bfloat16,
                                              seed=33, **h2o)
    # qwen2-7b's group of 7 (28 heads over 4) at hd 128
    qwen = {"h": 28, "kh": 4, "hd": 128}
    for b, t, dt in ((8, 48, torch.bfloat16),
                     (GEN_ROWS, GEN_PROMPT, torch.bfloat16),
                     (10, 48, torch.float32)):
        out[f"flash_qwen2_{b}x{t}_{str(dt).split('.')[-1]}"] = check_flash(
            dev, b, t, dt, seed=t + 7, **qwen)
    for dt in (torch.bfloat16, torch.float32):
        out[f"decode_qwen2_path_{str(dt).split('.')[-1]}"] = check_decode(
            dev, GEN_ROWS, s_path, dt, seed=34, lens=[s_path - 1] * GEN_ROWS,
            **qwen)
    # zamba2-7b's shared attention block: hd 112, MHA (32 heads over 32,
    # a group of 1): a serve window, the generate prefill; decode over
    # the generate path's 544 slots
    zamba = {"h": 32, "kh": 32, "hd": 112}
    for b, t, dt in ((8, 48, torch.bfloat16),
                     (GEN_ROWS, GEN_PROMPT, torch.bfloat16),
                     (8, 48, torch.float32)):
        out[f"flash_zamba2_{b}x{t}_{str(dt).split('.')[-1]}"] = check_flash(
            dev, b, t, dt, seed=t + 112, **zamba)
    for dt in (torch.bfloat16, torch.float32):
        out[f"decode_zamba2_path_{str(dt).split('.')[-1]}"] = check_decode(
            dev, GEN_ROWS, s_path, dt, seed=35, lens=[s_path - 1] * GEN_ROWS,
            **zamba)
    out["maxconf_path"] = check_maxconf(dev, GEN_ROWS, 64000, seed=22)
    out["maxconf_152k"] = check_maxconf(dev, 32, 152064, seed=23, cold=True)
    # rwkv6-1.6b's time mix (32 heads of 64): the generate prefill, a
    # serve window of 8 x 48, a decode step with the state in place
    out["rwkv6_prefill"] = check_rwkv6_scan(
        dev, GEN_ROWS, GEN_PROMPT, 32, 64, torch.bfloat16, seed=26)
    out["rwkv6_window"] = check_rwkv6_scan(dev, 8, 48, 32, 64,
                                           torch.bfloat16, seed=27)
    out["rwkv6_decode_aliased"] = check_rwkv6_scan(
        dev, GEN_ROWS, 1, 32, 64, torch.bfloat16, seed=28, aliased=True)
    out["rwkv6_carry"] = check_rwkv6_carry(dev)
    # MDSA: the supervisor phase's shape (1024 test rows of a 64-wide
    # penultimate layer), yi-6b's width, and ragged shapes
    out["mdsa_path"] = check_mdsa(dev, 1024, 64, seed=29)
    out["mdsa_4096"] = check_mdsa(dev, 256, 4096, seed=30)
    for b, d in ((8, 64), (128, 128), (100, 200), (1, 32)):
        out[f"mdsa_{b}x{d}"] = check_mdsa(dev, b, d, seed=b + d)
    return out


# ----------------------------------------------------------------------------
# model and serve phases
# ----------------------------------------------------------------------------

def cache_err(card: dict, cpu: dict) -> float:
    """Largest difference between two caches' leaves (the KV cache's k
    and v, or the RWKV6 state's wkv, tm_prev and cm_prev)."""
    from repro_torch.tree import tree_leaves
    return max(float((g.cpu() - c).abs().max())
               for g, c in zip(tree_leaves(card), tree_leaves(cpu)))


# the reduced configs the model phases hold card against CPU: each
# family of the port (GQA; QKV bias; a group of 4 at hd 80 under a
# window; MLA + MoE after a dense layer; GQA + MoE; RWKV6; the zamba
# hybrid in 2 groups at hd 64 and 112; the VLM on patch embeddings and
# tokens; the encoder on frame embeddings, prefill only)
REDUCED_ARCHS = ("yi-6b", "qwen2-7b", "deepseek-67b", HD80,
                 "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", RWKV_ARCH,
                 ZAMBA2G, ZAMBA112, VLM_ARCH, AUDIO_ARCH)


def reduced_config(arch: str):
    """``arch``'s reduced config; HD80 is reduced h2o-danube widened to
    d_model 320 over 4 heads of 80 (2 KV heads), its window 64; ZAMBA2G
    and ZAMBA112 reduced zamba2 with 4 layers in 2 groups, at d_model
    256 and 448 over 4 heads (hd 64 and 112, MHA)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch.split("@")[0]).reduced()
    if arch == HD80:
        cfg = dataclasses.replace(cfg, d_model=320, num_heads=4,
                                  num_kv_heads=2)
    if arch in (ZAMBA2G, ZAMBA112):
        cfg = dataclasses.replace(cfg, num_layers=4, shared_attn_period=2,
                                  d_model=448 if arch == ZAMBA112 else 256)
    return cfg


def prompt_batch(cfg, rng, b: int, t: int) -> dict:
    """A numpy prompt of length t: tokens [b, t]; for a VLM t // 2 patch
    embeddings, then t - t // 2 tokens; for an arch without a token
    embedding, t frame embeddings."""
    from repro_torch.models import transformer as T
    patches = t // 2 if cfg.family == "vlm" else \
        0 if T.takes_tokens(cfg) else t
    out = {}
    if patches:
        out["embeds"] = rng.standard_normal(
            (b, patches, cfg.d_model)).astype(np.float32)
    if t > patches:
        out["tokens"] = rng.integers(1, cfg.vocab_size, (b, t - patches))
    return out


def model_phase(dev) -> list[dict]:
    """Reduced prefill of every family: the card (kernels) against the CPU
    (plain versions) on the same weights and tokens."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    rows = []
    for arch in REDUCED_ARCHS:
        cfg = reduced_config(arch)
        params = T.init_params(cfg, torch.Generator("cpu").manual_seed(3))
        batch = prompt_batch(cfg, np.random.default_rng(17), 3, 40)
        with torch.no_grad():
            lc, cc = T.prefill(cfg, params, batch)
            lg, cg = T.prefill(cfg, tree_map(lambda a: a.to(dev), params),
                               batch)
        torch.cuda.synchronize()
        err = max(float((lg.cpu() - lc).abs().max()), cache_err(cg, cc))
        row = {"phase": "model", "config": arch, "max_abs_err": err,
               "atol": 1e-3}
        log(row)
        assert err <= 1e-3, f"reduced prefill card vs cpu ({arch}): {err}"
        rows.append(row)
    return rows


def decode_model_phase(dev) -> list[dict]:
    """Every reduced family that decodes (the encoder does not), and
    reduced h2o-danube at hd 64 (prompt 96 > window 64: the ring buffer
    wraps, as it does at hd 80), MLA's latent cache and the RWKV6 and
    mamba2 states updated in place, the VLM after a prompt of patch
    embeddings and tokens: prefill, then decode a fixed token sequence
    (teacher-forced) on the card (kernels) and on the CPU (plain
    versions), on the same weights; logits at every step and the final
    caches agree within 1e-3."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import graft
    from repro_torch.tree import tree_map
    rows = []
    for arch in REDUCED_ARCHS + ("h2o-danube-1.8b",):
        cfg = reduced_config(arch)
        if not cfg.supports_decode:
            continue
        params = T.init_params(cfg, torch.Generator("cpu").manual_seed(5))
        gparams = tree_map(lambda a: a.to(dev), params)
        rng = np.random.default_rng(24)
        prompt = prompt_batch(cfg, rng, 3, 96)
        forced = rng.integers(1, cfg.vocab_size, (3, 8))
        caches, logits = {}, {}
        for where, p in (("cpu", params), ("card", gparams)):
            d = "cpu" if where == "cpu" else dev
            with torch.no_grad():
                _, pc = T.prefill(cfg, p, prompt)
                cache = graft(T.make_cache(cfg, 3, 96 + 8, d), pc)
                steps = []
                for i in range(forced.shape[1]):
                    lg, cache = T.decode_step(cfg, p, forced[:, i], cache,
                                              96 + i)
                    steps.append(lg.cpu())
            caches[where], logits[where] = cache, torch.stack(steps)
        torch.cuda.synchronize()
        err = max(float((logits["card"] - logits["cpu"]).abs().max()),
                  cache_err(caches["card"], caches["cpu"]))
        kv = caches["card"].get("main", caches["card"].get("attn_k"))
        if isinstance(kv, dict):
            kv = next(iter(kv.values()))
        row = {"phase": "decode_model", "config": arch,
               "slots": None if kv is None else int(kv.shape[2]),
               "steps": int(forced.shape[1]), "max_abs_err": err,
               "atol": 1e-3}
        log(row)
        assert err <= 1e-3, f"reduced decode card vs cpu ({arch}): {err}"
        rows.append(row)
    return rows


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


def build_serve_stack(dev, argv):
    """Parse ``argv`` and build the serve stack (task, trained surrogate,
    full-width remote tier, calibration); check the remote tier's
    full-width prefill: finite logits, and a cache of the expected
    shapes. Returns (args, stack, setup seconds)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    args = serve.parse_args(argv)
    stack = serve.build_stack(args)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    with torch.no_grad():
        logits, cache = T.prefill(
            stack.rcfg, stack.rparams,
            {"tokens": stack.toks[:2] % stack.rcfg.vocab_size})
    rc = stack.rcfg
    assert logits.shape == (2, rc.vocab_size), logits.shape
    assert tree_map(lambda a: tuple(a.shape), cache) \
        == prefill_cache_shapes(rc, 2, stack.toks.shape[1])
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(cache))
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    return args, stack, setup_s


def prefill_cache_shapes(rc, b: int, t: int) -> dict:
    """The shapes of the cache a prefill of [b, t] tokens returns: the
    RWKV6 state; zamba's mamba2 state and per-group keys and values; per
    stack ("dense" for the first dense-MLP layers, "main") the keys and
    values, or MLA's latent and rope key."""
    if rc.block_type == "mamba2":
        from repro_torch.models import mamba2 as m2
        from repro_torch.models import transformer as T
        d_inner, h, n = m2.dims(rc)
        w, l_ = m2.CONV_W - 1, rc.num_layers
        kv = (T.zamba_groups(rc)[0], b, t, rc.num_kv_heads,
              rc.resolved_head_dim)
        return {"mamba": {"ssm": (l_, b, h, m2.HEAD_P, n),
                          "conv_x": (l_, b, w, d_inner),
                          "conv_bc": (l_, b, w, 2 * n)},
                "attn_k": kv, "attn_v": kv}
    if rc.block_type == "rwkv6":
        h, m = rc.d_model // rc.rwkv_head_dim, rc.rwkv_head_dim
        n = rc.num_layers
        return {"rwkv": {"wkv": (n, b, h, m, m), "tm_prev": (n, b, rc.d_model),
                         "cm_prev": (n, b, rc.d_model)}}
    s = min(t, rc.sliding_window) if rc.sliding_window else t
    if rc.use_mla:
        leaves = {"c_kv": (b, s, rc.kv_lora_rank),
                  "k_rope": (b, s, rc.qk_rope_head_dim)}
    else:
        kv = (b, s, rc.num_kv_heads, rc.resolved_head_dim)
        leaves = {"k": kv, "v": kv}
    n_dense = rc.first_dense_layers
    out = {"main": {k: (rc.num_layers - n_dense, *v)
                    for k, v in leaves.items()}}
    if n_dense:
        out["dense"] = {k: (n_dense, *v) for k, v in leaves.items()}
    return out


def serve_main_run(dev, args, stack, kernels) -> tuple:
    """The main path: the window scheduler over the gated local step,
    with every launch count set to 0 just before and read just after.
    Asserts the serving checks, that each of ``kernels`` launched, and
    the accepted accuracy. Returns (result, summary)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    reset_launch_counts()
    res = serve.run(args, stack)
    torch.cuda.synchronize(dev)
    counts = launch_counts()
    main = serve_checks(res, args.requests)
    main["launches"] = counts
    for name in kernels:
        assert counts[name] > 0, f"{name} never launched on the path"
    acc = np.mean([r.prediction == stack.labels[r.uid]
                   for r in res.responses if r.source != "fallback"])
    main["accepted_accuracy"] = float(acc)
    assert acc > 0.9, f"accepted accuracy {acc}"
    return res, main


def serve_phase(dev, argv=SERVE_ARGV):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_head_gate.ops import FusedLocalHead
    from repro_torch.launch import serve
    from repro_torch.models import surrogate as S

    torch.cuda.reset_peak_memory_stats(dev)
    args, stack, setup_s = build_serve_stack(dev, argv)
    rc = stack.rcfg
    res, main = serve_main_run(dev, args, stack,
                               ("gate_score", "gate_select",
                                "flash_attention"))

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
    return out, stack


def attention_layers(rc) -> int:
    """The layers that run an attention (or RWKV6 scan) kernel once per
    prefill or decode step: zamba's groups (its shared block), else
    every layer."""
    from repro_torch.models import transformer as T
    if rc.block_type == "mamba2":
        return T.zamba_groups(rc)[0]
    return rc.num_layers


def remote_serve_phase(dev, arch: str, phase: str) -> tuple:
    """``--remote-arch arch`` at full width: the same requests and checks
    as the yi-6b serve run. Per remote window, every layer launches the
    RWKV6 scan (rwkv6) or flash attention (GQA; zamba: once per group,
    its mamba2 layers none), or neither (MLA, whose attention is plain
    PyTorch); decode attention never launches."""
    torch.cuda.reset_peak_memory_stats(dev)
    args, stack, setup_s = build_serve_stack(
        dev, SERVE_ARGV + ["--remote-arch", arch])
    rc = stack.rcfg
    per_layer = ("rwkv6_scan" if rc.block_type == "rwkv6" else
                 None if rc.use_mla else "flash_attention")
    res, main = serve_main_run(dev, args, stack, (
        "gate_score", "gate_select") + ((per_layer,) if per_layer else ()))
    counts = main["launches"]
    for name in ("rwkv6_scan", "flash_attention", "decode_attention"):
        want = (attention_layers(rc) * main["remote_windows"]
                if name == per_layer else 0)
        assert counts[name] == want, \
            f"{name}: {counts[name]} launches, not {want}"
    out = {"setup_s": setup_s, "main": main, "remote": rc.name,
           "remote_layers": rc.num_layers,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log({"phase": phase, **out})
    out["remote_window_profile"] = profile_remote_window(stack)
    return out, stack


def free(dev) -> None:
    """Return the freed model's memory to the card, so that the next
    phase measures its own peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)


def device_profile(fn) -> dict:
    """One call of ``fn`` (ending in a synchronize) under torch.profiler:
    its traced wall time, device (kernel) time by name and the device's
    busy share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        traced_ms = (time.perf_counter() - t0) * 1e3

    device_us = _device_us
    # kernel events only (an operator's device time repeats its kernels')
    kern = sorted(((e.key, device_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and device_us(e) > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kern)
    return {"traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms if kern else None,
            "device_busy_share": busy_ms / traced_ms if kern else None,
            "top_kernels_ms": [[k, round(ms, 4), n] for k, ms, n in kern[:8]]}


def profile_remote_window(stack, rows: int = 8, reps: int = 5) -> dict:
    """Where one remote transport window's time goes: its wall time
    unprofiled (median of ``reps``), then one run under torch.profiler
    for device (kernel) time by name and the device's busy share."""
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
    row = {"phase": "remote_window_profile", "rows": rows,
           "tokens": int(batch["tokens"].shape[1]),
           "wall_ms": statistics.median(walls), **device_profile(window)}
    log(row)
    return row


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


@contextlib.contextmanager
def recorded_routes():
    """While open, every MoE layer's top-k expert ids [tokens, k], in
    call order, are appended to the list it yields."""
    from repro_torch.models import moe
    calls, route = [], moe.route

    def recording(cfg, p, xf):
        out = route(cfg, p, xf)
        calls.append(out[0])
        return out

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def route_flips(dec: list, pre: list) -> tuple[int, int]:
    """(flips, compared): dec[i] holds decode step i's per-layer top-k ids
    [rows, k]; pre[i] the fresh prefill's over the prompt and tokens[:i]
    at its last position. Step i decodes the token that prefill i + 1
    ends on: a flip is a (step, layer, row) whose expert set differs."""
    flips = compared = 0
    for d_step, p_step in zip(dec, pre[1:]):
        for d, p in zip(d_step, p_step):
            diff = (d.sort(-1).values != p.sort(-1).values).any(-1)
            flips += int(diff.sum())
            compared += diff.numel()
    return flips, compared


def generate_phase(dev, stack, rows: int = GEN_ROWS,
                   prompt_len: int = GEN_PROMPT, patches: int = 0) -> dict:
    """Greedy generation with the serve stack's remote model at full width
    on its weights: ``rows`` prompts of ``prompt_len`` positions (a VLM's
    first ``patches`` of them patch embeddings from ``frontend_embeddings``,
    the rest tokens), GEN_TOKENS new tokens.
    Asserts shapes, finite likelihoods in (0, 1], the kernels' launches
    on that run (MLA and the RWKV6 stack launch no attention kernel),
    that a teacher-forced replay of the decode loop on the generated
    tokens picks those same tokens (so what is timed and compared below
    is the main path's run), that each step's replayed decode logits lie
    within GEN_LOGIT_TOL[arch] of a fresh prefill's over the prompt and
    the tokens before it (at every PREFILL_STRIDE[arch]-th step, default
    every step), and that each decoded token is what that prefill picks
    wherever its top-2 gap exceeds DECISIVE_GAP[arch] (the tolerance
    where none is given).
    Times the decode steps of the replay, profiles one, and applies the
    2nd supervisor (seq_min_likelihood) to the answers."""
    from repro_torch.core.supervisors import seq_min_likelihood
    from repro_torch.core.thresholds import nominal_quantile_threshold
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.maxconf.ops import maxconf
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import frontend_embeddings
    from repro_torch.serving.generate import graft, greedy_generate
    cfg, params = stack.rcfg, stack.rparams
    n_l, n_attn = cfg.num_layers, attention_layers(cfg)
    prompt = np.random.default_rng(25).integers(
        1, cfg.vocab_size, (rows, prompt_len - patches))
    batch = {"tokens": prompt}
    if patches:
        batch["embeds"] = frontend_embeddings(cfg, rows, patches, seed=25,
                                              device=dev)
    greedy_generate(cfg, params, batch, 2)          # warm-up (cuBLAS plans)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, liks = greedy_generate(cfg, params, batch, GEN_TOKENS)
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    assert toks.shape == liks.shape == (rows, GEN_TOKENS), toks.shape
    assert toks.dtype == torch.int32 and liks.dtype == torch.float32
    assert bool(torch.isfinite(liks).all()), "non-finite likelihoods"
    assert bool(((liks > 0) & (liks <= 1)).all()), "likelihood outside (0,1]"
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    rwkv = cfg.block_type == "rwkv6"
    tol = GEN_LOGIT_TOL[cfg.name]
    if rwkv:    # one scan per layer for the prefill and for every step
        want = {"rwkv6_scan": n_l * GEN_TOKENS, "maxconf": GEN_TOKENS,
                "flash_attention": 0, "decode_attention": 0}
    elif cfg.use_mla:   # MLA's attention is plain PyTorch
        want = {"maxconf": GEN_TOKENS, "flash_attention": 0,
                "decode_attention": 0}
    else:   # zamba: its shared block's per group, mamba2 plain PyTorch
        want = {"decode_attention": n_attn * (GEN_TOKENS - 1),
                "maxconf": GEN_TOKENS, "flash_attention": n_attn}
    for name, n in want.items():
        assert counts[name] == n, f"{name}: {counts[name]} launches, not {n}"

    # decode steps alone, teacher-forced on the generated tokens (per-step
    # host clock around work that ends in a synchronize); keeps each
    # step's logits for the comparison with fresh prefills below
    with torch.no_grad():
        lg0, pc = T.prefill(cfg, params, batch)
        cache = graft(T.make_cache(cfg, rows, prompt_len + GEN_TOKENS, dev),
                      pc)
        dec_logits, step_ms, dec_routes = [lg0], [], []
        replay = torch.zeros_like(toks)
        replay[:, 0] = maxconf(lg0)["prediction"]
        with recorded_routes() as routes:   # the MoE layers' choices
            for i in range(GEN_TOKENS - 1):
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                lg, cache = T.decode_step(cfg, params, toks[:, i], cache,
                                          prompt_len + i)
                replay[:, i + 1] = maxconf(lg)["prediction"]
                torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t1) * 1e3)
                dec_logits.append(lg)
                dec_routes.append(routes[:])
                routes.clear()
        # the replay picks the tokens it was fed: it is the main path's run
        assert torch.equal(replay, toks), \
            f"replay picks {int((replay != toks).sum())} tokens differently"

        def one_step():
            with torch.no_grad():
                lg, _ = T.decode_step(cfg, params, toks[:, -2], cache,
                                      prompt_len + GEN_TOKENS - 2)
                maxconf(lg)
            torch.cuda.synchronize(dev)

        profile = device_profile(one_step)

        # self-consistency: token i == argmax of a fresh prefill over
        # prompt + tokens[:i] where that prefill's top-2 gap allows it (at
        # every stride-th step)
        stride = PREFILL_STRIDE.get(cfg.name, 1)
        seq = torch.as_tensor(prompt, device=dev)
        diffs, gaps, hits, pre_routes = [], [], [], []
        for i in range(GEN_TOKENS):
            routes = []
            if i % stride == 0:
                with recorded_routes() as routes:
                    lp, _ = T.prefill(cfg, params, {**batch, "tokens": seq})
                gaps.append(top2_gap(lp))
                hits.append(lp.argmax(-1).to(torch.int32) == toks[:, i])
                diffs.append((dec_logits[i] - lp).abs().amax(-1))  # per row
            pre_routes.append([r.view(rows, -1, r.shape[-1])[:, -1]
                               for r in routes])
            seq = torch.cat([seq, toks[:, i:i + 1].long()], dim=1)
        torch.cuda.synchronize(dev)
    diff = torch.stack(diffs).float().cpu()
    diff_q = torch.quantile(diff.flatten(), torch.tensor(
        [0.5, 0.9, 1.0])).tolist()
    max_diff = float(diff.max())
    flips, compared = route_flips(dec_routes, pre_routes)
    gap, hit = torch.stack(gaps), torch.stack(hits)
    decisive = DECISIVE_GAP.get(cfg.name, tol)
    ok = gap > decisive
    checked, agree = int(ok.sum()), int((ok & hit).sum())
    pairs = rows * len(gaps)
    gap_q = torch.quantile(gap.flatten().float().cpu(),
                           torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9])).tolist()
    assert max_diff <= tol, \
        f"{cfg.name}: decode and prefill logits differ by {max_diff} " \
        f"> {tol} (prefill top-2 gap quantiles {gap_q})"
    assert checked == agree, \
        f"{cfg.name}: {checked - agree} decoded tokens differ from a " \
        f"fresh prefill with a top-2 gap above {decisive}"
    floor = pairs // CHECKED_FLOOR.get(cfg.name, 8)
    assert checked >= floor, \
        f"only {checked} of {pairs} tokens had a decisive prefill gap"

    conf = seq_min_likelihood(liks).cpu().numpy()
    t_remote = nominal_quantile_threshold(conf, 0.25)
    med_ms = statistics.median(step_ms)
    slots = prompt_len + GEN_TOKENS
    if cfg.sliding_window:
        slots = min(slots, cfg.sliding_window)
    out = {"phase": "generate", "config": cfg.name, "layers": n_l,
           "rows": rows, "prompt": prompt_len, "patches": patches,
           "new_tokens": GEN_TOKENS,
           "wall_s": wall_s,
           "tokens_per_s_end_to_end": rows * GEN_TOKENS / wall_s,
           "decode_step_ms_median": med_ms,
           "decode_step_ms_range": [min(step_ms), max(step_ms)],
           "decode_tokens_per_s": rows / med_ms * 1e3,
           "peak_mem_gib": peak_gib, "launches": counts,
           "prefill_checked": checked, "prefill_agree": agree,
           "pairs": pairs, "prefill_stride": stride, "logit_tol": tol,
           "decisive_gap": decisive,
           "decode_vs_prefill_logit_diff_q50_90_100": diff_q,
           "moe_route_flips": flips, "moe_routes_compared": compared,
           "prefill_top2_gap_q10_25_50_75_90": gap_q,
           "decode_vs_prefill_max_logit_diff": max_diff,
           "replay_agree": int((replay == toks).sum()),
           "seq_min_likelihood": conf.tolist(), "t_remote": t_remote,
           "accepted": int((conf > t_remote).sum()),
           "rejected": int((conf <= t_remote).sum())}
    log(out)
    out["decode_step_profile"] = prof_row = {
        "phase": "decode_step_profile", "config": cfg.name, "rows": rows,
        "kv_slots": None if rwkv else slots, **profile}
    log(prof_row)
    return out


def auc_roc(conf: np.ndarray, correct: np.ndarray) -> float:
    """P(conf_correct > conf_wrong) + 0.5 P(=): Mann-Whitney with average
    ranks for ties."""
    pos, neg = conf[correct], conf[~correct]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    _, inv, counts = np.unique(np.concatenate([pos, neg]),
                               return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    r_pos = ranks[:len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))


def supervisor_phase(dev) -> dict:
    """The supervisor comparison of ``benchmarks/supervisor_comparison.py``
    on the card, with the port's own functions: the same task (seed 7,
    2048 inputs, 6 classes) and surrogate (d_model 48, d_ff 64, dropout
    0.1), trained 50 steps on the first 1024 inputs by launch/serve.py's
    ``train_surrogate``. The main path: MDSA fitted on the training-set
    penultimate activations and the test set scored through the MDSA
    kernel (held to its plain version); then the AUC-ROC of every
    supervisor at telling the surrogate's correct test predictions from
    its wrong ones."""
    from repro_torch.core import supervisors as SV
    from repro_torch.data.synthetic import make_classification_task
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mdsa.ref import mdsa_ref
    from repro_torch.launch.serve import train_surrogate
    from repro_torch.models import surrogate as S
    vocab, seq, ncls, n_train = 256, 32, 6, 1024
    toks, labels, _ = make_classification_task(
        7, n=2048, vocab=vocab, seq_len=seq, num_classes=ncls)
    cfg = S.SurrogateConfig("cmp", vocab_size=vocab, max_len=seq, d_model=48,
                            num_heads=2, d_ff=64, num_classes=ncls,
                            dropout=0.1)
    t0 = time.perf_counter()
    models = [train_surrogate(cfg, toks[:n_train], labels[:n_train],
                              steps=50, seed=seed, device=dev)[0]
              for seed in (0, 1, 2)]
    params = models[0]
    tk = torch.as_tensor(toks, device=dev)
    with torch.no_grad():
        logits, hidden = S.apply(cfg, params, tk[n_train:],
                                 return_hidden=True)
        _, train_hidden = S.apply(cfg, params, tk[:n_train],
                                  return_hidden=True)
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    correct = (logits.argmax(-1).cpu().numpy() == labels[n_train:])

    # the main path
    reset_launch_counts()
    state = SV.fit_mdsa(train_hidden)
    mdsa_conf = SV.mdsa_confidence(state, hidden)
    torch.cuda.synchronize(dev)
    counts = launch_counts()
    assert counts["mdsa"] > 0, "mdsa never launched on the path"
    want = -mdsa_ref(hidden, state.mean, state.prec)
    err = float((mdsa_conf - want).abs().max())
    assert torch.allclose(mdsa_conf, want, rtol=MDSA_RTOL, atol=MDSA_RTOL), \
        f"mdsa confidences vs plain: max err {err}"
    assert mdsa_conf.shape == (len(correct),)
    assert bool(torch.isfinite(mdsa_conf).all() & (mdsa_conf <= 0).all())

    confs = {name: fn(logits)
             for name, fn in SV.SOFTMAX_SUPERVISORS.items()}
    confs["mdsa"] = mdsa_conf
    ae = SV.fit_autoencoder(torch.Generator(dev).manual_seed(1),
                            train_hidden, latent=8, steps=200)
    confs["autoencoder"] = SV.autoencoder_confidence(ae, hidden)
    gen = torch.Generator(dev).manual_seed(2)
    with torch.no_grad():
        samples = torch.stack([S.apply(cfg, params, tk[n_train:],
                                       dropout_rng=gen, mc_dropout=True)
                               for _ in range(8)])
        ens = torch.stack([S.apply(cfg, p, tk[n_train:]) for p in models])
    confs["mc_dropout(vr)"] = SV.variation_ratio(samples)
    confs["mc_dropout(mi)"] = SV.mutual_information(samples)
    confs["ensemble(mms)"] = SV.mean_max_softmax(ens)
    aucs = {name: auc_roc(c.float().cpu().numpy(), correct)
            for name, c in confs.items()}
    for name, a in aucs.items():
        assert 0.0 <= a <= 1.0, f"{name}: AUC-ROC {a}"
    out = {"phase": "supervisors", "train_s": train_s,
           "test_rows": int(len(correct)), "hidden_width": cfg.d_ff,
           "surrogate_accuracy": float(correct.mean()),
           "mdsa_max_abs_err_vs_plain": err, "launches": counts,
           "auc_roc": aucs}
    log(out)
    return out


# ----------------------------------------------------------------------------
# train phases
# ----------------------------------------------------------------------------

def train_batch(cfg, rng, b: int, t: int) -> dict:
    """A numpy train batch of length t (``prompt_batch``'s inputs), with
    per-frame labels for an encoder."""
    batch = prompt_batch(cfg, rng, b, t)
    if cfg.is_encoder:
        batch["labels"] = rng.integers(0, cfg.num_classes, (b, t))
    return {k: v.astype(np.int32) if v.dtype.kind == "i" else v
            for k, v in batch.items()}


def train_parity_phase(dev) -> list[dict]:
    """Reduced yi-6b, h2o-danube (T = 128: its window of 64 masks), rwkv6,
    zamba2 in 2 groups, pixtral (64 patch embeddings, then 64 tokens:
    the loss over the text only) and hubert (128 frames, per-frame
    labels), fp32: ``loss_fn`` and every gradient leaf on the card
    against the CPU on the same weights and inputs; one in-place AdamW
    step on the
    card against the functional one (bit for bit) and against the CPU's
    from the same gradients; a checkpoint of (params, opt_state) saved
    and loaded on the card, bit for bit. No kernel launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    rows = []
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in ("yi-6b", "h2o-danube-1.8b", RWKV_ARCH, ZAMBA2G, VLM_ARCH,
                 AUDIO_ARCH):
        cfg = reduced_config(arch)
        params = T.init_params(cfg, torch.Generator("cpu").manual_seed(11))
        gparams = tree_map(lambda a: a.to(dev), params)
        batch = train_batch(cfg, np.random.default_rng(31), 2, TRAIN_SEQ)
        reset_launch_counts()
        loss_c, met_c, g_c = value_and_grad(cfg, params, batch)
        loss_g, met_g, g_g = value_and_grad(cfg, gparams, batch)
        torch.cuda.synchronize()
        launched = sum(launch_counts().values())
        assert launched == 0, f"{arch}: the train path launched kernels"
        loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        assert loss_rel <= 1e-5, f"{arch}: loss card vs cpu {loss_rel}"
        grad_used = 0.0
        for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
            lim = GRAD_TOL[arch] * float(b.abs().max()) + 1e-7
            grad_used = max(grad_used,
                            float((a.cpu() - b).abs().max()) / lim)
        assert grad_used <= 1, f"{arch}: gradients {grad_used} of the limit"
        # one AdamW step from the CPU's gradients on both devices
        g_cg = tree_map(lambda a: a.to(dev), g_c)
        cp, cs, _ = opt.adamw_update(ocfg, params, g_c,
                                     opt.init_opt_state(params))
        fp, fs, _ = opt.adamw_update(ocfg, gparams, g_cg,
                                     opt.init_opt_state(gparams))
        istate = opt.init_opt_state(gparams)
        opt.adamw_step_(ocfg, gparams, g_cg, istate)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves((gparams, istate["m"], istate["v"])),
            tree_leaves((fp, fs["m"], fs["v"])))), \
            f"{arch}: in-place and functional AdamW differ on the card"
        step_err = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(tree_leaves(fp), tree_leaves(cp)))
        mom_used = max(float(((a.cpu() - b).abs()
                              / (1e-5 * b.abs() + 1e-12)).max())
                       for a, b in zip(tree_leaves((fs["m"], fs["v"])),
                                       tree_leaves((cs["m"], cs["v"]))))
        assert step_err <= 1e-6 and mom_used <= 1, \
            f"{arch}: AdamW step card vs cpu {step_err}, moments {mom_used}"
        path = ROOT / "build" / f"train_parity_{arch}.msgpack"
        ck.save_checkpoint(str(path), (gparams, istate), step=1)
        (lp, ls), step = ck.load_checkpoint(
            str(path), (gparams, opt.init_opt_state(gparams)))
        path.unlink()
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((lp, ls["m"], ls["v"])),
            tree_leaves((gparams, istate["m"], istate["v"]))))
        assert exact and step == 1 and ls["step"] == 1, \
            f"{arch}: checkpoint round trip not exact"
        row = {"phase": "train_parity", "config": arch,
               "batch": {k: list(v.shape) for k, v in batch.items()},
               "window": cfg.sliding_window or None,
               "loss_card": float(loss_g), "loss_cpu": float(loss_c),
               "loss_rel_err": loss_rel,
               "acc_card": float(met_g["acc"]), "acc_cpu": float(met_c["acc"]),
               "grad_leaves": len(tree_leaves(g_g)),
               "grad_share_of_limit": grad_used, "grad_tol": GRAD_TOL[arch],
               "adamw_inplace_equals_functional": True,
               "adamw_step_max_abs_err": step_err,
               "adamw_moments_share_of_limit": mom_used,
               "checkpoint_round_trip_exact": exact, "kernel_launches": 0}
        log(row)
        rows.append(row)
    return rows


def train_phase(dev, arch: str, stream_steps: int, fixed_steps: int,
                phase: str) -> dict:
    """``arch`` at full width through ``repro_torch.launch.train``'s own
    functions, with the launcher's defaults (batch 8 x 128, remat, its
    lr and schedule for this many steps): one gradient for every leaf,
    checked finite; ``stream_steps`` steps of ``make_batches``, then
    ``fixed_steps`` of one fixed batch, whose loss must fall. No kernel
    may launch. Reports the median step time after the first step,
    tokens/s, MFU (6 N tokens / step time / the bf16 peak) and peak
    memory."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw_step_
    from repro_torch.tree import tree_leaves

    free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    steps = stream_steps + fixed_steps
    args = train.parse_args(["--arch", arch, "--steps", str(steps)])
    t0 = time.perf_counter()
    cfg, params, opt_state, step_fn = train.setup(args)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    static_gib = torch.cuda.memory_allocated(dev) / 2**30
    batches = train.make_batches(cfg, args.batch, args.seq)
    reset_launch_counts()
    # every leaf's gradient, once, on the stream's first batch
    first = train.to_device(next(batches), dev)
    _, _, grads = value_and_grad(cfg, params, first)
    leaves = tree_leaves(grads)
    n_leaves = len(tree_leaves(params))
    assert len(leaves) == n_leaves and all(g is not None for g in leaves)
    # 64 M elements at a time: isfinite's temporaries of a whole stacked
    # leaf would add ~5 GiB to the peak this phase reports
    finite = all(bool(torch.isfinite(c).all()) for g in leaves
                 for c in g.view(-1).split(1 << 26))
    assert finite, f"{arch}: a non-finite gradient"
    del grads, leaves
    history, step_s = [], []
    batch = first
    for i in range(steps):
        if 0 < i <= stream_steps:   # the last one stays: the fixed batch
            batch = train.to_device(next(batches), dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m)
        print(train.log_line(i + 1, m, step_s[-1]), flush=True)
    counts = launch_counts()
    assert sum(counts.values()) == 0, f"{arch}: kernels launched: {counts}"
    losses = [m["loss"] for m in history]
    assert all(math.isfinite(x) for x in losses), f"{arch}: {losses}"
    assert all(math.isfinite(m["grad_norm"]) for m in history)
    fixed_losses = losses[stream_steps:]
    assert fixed_losses[-1] < fixed_losses[0], \
        f"{arch}: the fixed batch's loss did not fall: {fixed_losses}"
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    assert peak_gib < card_gib
    med = statistics.median(step_s[1:])
    # where a step goes: its two halves timed apart (the gradient:
    # forward, recompute, backward; the AdamW step), then one whole step
    # under the profiler (device busy share, top kernels)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, _, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    grad_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    adamw_step_(train.opt_config(args), params, grads, opt_state)
    torch.cuda.synchronize(dev)
    grad_s, opt_s = t1 - t0, time.perf_counter() - t1
    opt_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del grads
    profile = device_profile(lambda: (step_fn(params, opt_state, batch),
                                      torch.cuda.synchronize(dev)))
    tokens = args.batch * args.seq
    out = {"phase": phase, "config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n_params,
           "batch": args.batch, "seq": args.seq, "remat": True,
           "lr": args.lr, "steps": steps, "stream_steps": stream_steps,
           "fixed_batch_steps": fixed_steps, "setup_s": setup_s,
           "grad_leaves": n_leaves, "grads_finite": finite,
           "step_s_median": med, "step_s": step_s, "grad_s": grad_s,
           "optimizer_s": opt_s,
           "tokens_per_s": tokens / med,
           "mfu": 6.0 * n_params * tokens / med / PEAK_FLOPS["bf16"],
           "static_gib": static_gib,
           "peak_mem_gib": peak_gib, "card_mem_gib": card_gib,
           "grad_peak_gib": grad_peak, "optimizer_peak_gib": opt_peak,
           "loss": losses, "ln_vocab": math.log(cfg.vocab_size),
           "grad_norm": [m["grad_norm"] for m in history],
           "lr_schedule": [m["lr"] for m in history],
           "kernel_launches": 0}
    log(out)
    out["step_profile"] = prof_row = {"phase": f"{phase}_step_profile",
                                      "config": cfg.name, **profile}
    log(prof_row)
    del params, opt_state, step_fn
    free(dev)
    return out


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
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:27"),
    "maxconf": ("src/repro_torch/csrc/maxconf.cu",
                "src/repro/kernels/maxconf/kernel.py:36"),
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan/kernel.py:28"),
    "mdsa": ("src/repro_torch/csrc/mdsa.cu",
             "src/repro/kernels/mdsa/kernel.py:28"),
}


def kernels_line(kern: dict, serve: dict, gen: dict, rwkv_gen: dict,
                 sup: dict) -> dict:
    """One entry per kernel at the shape its path gives it: the serving
    path's kernels with the serve run's launches, the generate path's
    with the generate run's (the RWKV6 scan: rwkv6's generate run, at its
    prefill's shape), MDSA with the supervisor phase's."""
    path_rows = {"gate_score": kern["gate_path"]["gate_score"],
                 "gate_select": kern["gate_path"]["gate_select"],
                 "fused_head_gate": kern["head_path"],
                 "flash_attention": kern["flash_8x48_bfloat16"],
                 "decode_attention": kern["decode_path_bfloat16"],
                 "maxconf": kern["maxconf_path"],
                 "rwkv6_scan": kern["rwkv6_prefill"],
                 "mdsa": kern["mdsa_path"]}
    launches = dict(serve["main"]["launches"])
    launches["fused_head_gate"] = serve["fused_head"]["launches"][
        "fused_head_gate"]
    for name in ("decode_attention", "maxconf"):
        launches[name] = gen["launches"][name]
    launches["rwkv6_scan"] = rwkv_gen["launches"]["rwkv6_scan"]
    launches["mdsa"] = sup["launches"]["mdsa"]
    out = []
    for name, row in path_rows.items():
        src, repl = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[name],
                    "max_abs_err": row["max_abs_err"],
                    "ms": row["kernel_ms"],
                    "device_ms": row.get("device_ms"),
                    "device_kernels_per_call": row.get(
                        "device_kernels_per_call"),
                    "plain_ms": row["plain_ms"],
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

    phases = RESULTS["phases"]
    # each phase's seconds, the frees between them in the next one's
    seconds = RESULTS["phase_s"] = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name], clock[0] = now - clock[0], now

    phases["kernels"] = kern = kernel_phase(dev)
    lap("kernels")
    phases["model"] = model_phase(dev)
    phases["decode_model"] = decode_model_phase(dev)
    lap("model")
    serve, stack = serve_phase(dev)
    phases["serve"] = serve
    phases["generate"] = gen = generate_phase(dev, stack)
    lap("yi-6b")
    phases["supervisors"] = sup = supervisor_phase(dev)
    lap("supervisors")
    # free yi-6b, so that rwkv6's phases measure their own peak memory
    del stack
    free(dev)
    phases["serve_rwkv6"], stack = remote_serve_phase(dev, RWKV_ARCH,
                                                      "serve_rwkv6")
    phases["generate_rwkv6"] = rwkv_gen = generate_phase(dev, stack)
    lap(RWKV_ARCH)
    # then each other full-width arch, one at a time
    for arch in FULL_WIDTH_ARCHS:
        del stack
        free(dev)
        phases[f"serve_{arch}"], stack = remote_serve_phase(
            dev, arch, f"serve_{arch}")
        phases[f"generate_{arch}"] = generate_phase(
            dev, stack, patches=GEN_PATCHES if arch == VLM_ARCH else 0)
        if stack.rcfg.sliding_window:
            phases[f"generate_{arch}_long"] = generate_phase(
                dev, stack, rows=1, prompt_len=LONG_PROMPT)
        lap(arch)
    # free it: the train phases measure their own peak memory
    del stack
    free(dev)
    phases["train_parity"] = train_parity_phase(dev)
    lap("train_parity")
    phases["train"] = train_phase(dev, "yi-6b", 6, 6, "train")
    lap("train")
    phases["train_rwkv6"] = train_phase(dev, RWKV_ARCH, 2, 4, "train_rwkv6")
    lap("train_rwkv6")
    phases["train_hubert"] = train_phase(dev, AUDIO_ARCH, 2, 4,
                                         "train_hubert")
    lap("train_hubert")
    log({"phase": "seconds", **seconds})
    line = kernels_line(kern, serve, gen, rwkv_gen, sup)
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
