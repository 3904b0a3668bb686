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
   decides it; times the decode steps as the main path runs them (on the
   dense archs the CUDA graph's replay, also counted on the device
   trace), profiles one, times calls whose graph is new against the
   eager loop, and applies the 2nd supervisor (``seq_min_likelihood``)
   to the answers;
6. runs the fleet runtime on the same yi-6b: the device -> edge -> cloud
   tier ladder through ``repro_torch.launch.serve`` (both hops the
   full-width remote tier: flash attention once per layer per window of
   either hop) and the degenerate 2-stage identity (a terminal
   ``CascadeStage`` serves as the plain backend); 4 replicas behind one
   cascade, through ``repro_torch.launch.serve`` with ``replicas=4`` and
   then as a ``ClusterHarness`` on a virtual clock over skewed traffic
   whose contents recur across replicas, run twice (every uid once,
   single fill, billing, cross-replica hits, the two runs' outputs equal
   bit for bit);
   and the remote router under a seeded 50% brownout in fifo and in
   streaming completion (every failure an injected one, the two modes
   billing alike); then early emit on the same yi-6b: 256 requests
   through the continuous batcher (streaming, pipeline depth 2), early
   emit off, on, off, on, then with one transport worker off and on,
   then the window drain at depth 1 and 2, every run answering and
   billing alike with the same kernel launches, one emit per window and
   no triple left stored (each run's req/s and remote window latency,
   the trusted-local rows' hand-back and the lag from dispatch to the
   gate triple on the host), and one profiled continuous run: the
   device's busy share, the streams of the local step and the remote
   prefill, and whether their kernels overlap;
7. mirrors ``benchmarks/supervisor_comparison.py`` on the card: trains a
   surrogate, fits MDSA on its training-set activations, scores the test
   set through the MDSA kernel and prints every supervisor's AUC-ROC;
8. frees yi-6b, then serves 256 requests with rwkv6-1.6b at full width
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
9. frees the last of them, then holds the train path (``loss_fn``, every
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
   After step 6 it serves the same 256 (and 64 fused-head) requests with
   ``data_parallel=True``: the local forward on a (1, 1) serving mesh of
   an NCCL group of one, as DTensors; every response, the bill and the
   kernel launches equal the plain serve's (``serve_data_parallel``);
   after step 9 it trains yi-6b with ``--mesh 1,1`` (DTensor parameters,
   moments and batches) for 2 + 4 steps against the same steps without a
   mesh, losses within rtol 1e-5 (``train_mesh``);
10. runs each of the six ``repro_torch.examples`` through its ``main`` on
   the card with its own assertions (the training example at its ~100M
   scale for 50 steps, its loss falling; the long-context example's RWKV6
   scan and maxconf launches);
11. counts the roofline of the card's own paths with
   ``repro_torch.analysis.roofline`` on one chip (fake tensors on the
   CPU; the yi-6b serve window's prefill, its decode step and train
   step, rwkv6's and h2o-danube's decode steps), each beside the median
   this run measured (``roofline``), and runs the 256-rank fake-mesh
   dry-run of yi-6b and rwkv6-1.6b at decode_32k, of yi-6b at
   prefill_32k, of h2o-danube-1.8b at long_500k (batch 1: d_model
   laid over the idle ``data`` axis) and of qwen3-moe-235b-a22b at
   train_4k in subprocesses, yi-6b prefill_32k and h2o-danube long_500k
   held to JAX's dot FLOPs a chip, yi-6b prefill_32k and qwen3-moe
   train_4k to JAX's temporaries a chip (``dryrun``);
12. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero without the last line. Full results are also
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
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
# the archs whose decode loop runs as a CUDA graph (one GQA stack, no MoE)
GRAPH_ARCHS = {"yi-6b", "qwen2-7b", "h2o-danube-1.8b", "pixtral-12b"}
MISS_CALLS = 3      # generate calls on a new graph key, each a capture
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
# the plain serve phase's responses (yi-6b), for serve_data_parallel
PLAIN_SERVE: dict = {}
# the card's own paths for the roofline phase, (arch, kind, batch, seq),
# and the hand bounds PERF.md §2 worked out for them (ms)
ROOFLINE_PATHS = {"yi-6b serve window prefill": ("yi-6b", "prefill", 8, 48),
                  "yi-6b decode step": ("yi-6b", "decode", 8, 544),
                  "yi-6b train step": ("yi-6b", "train", 8, 128),
                  "rwkv6-1.6b decode step": (RWKV_ARCH, "decode", 8, 544),
                  "h2o-danube-1.8b decode step": ("h2o-danube-1.8b",
                                                  "decode", 8, 544)}
HAND_BOUND_MS = {"yi-6b decode step": 3.7, "yi-6b train step": 38.0,
                 "rwkv6-1.6b decode step": 0.93,
                 "h2o-danube-1.8b decode step": 1.1}
DRYRUN_COMBOS = (("qwen3-moe-235b-a22b", "train_4k"),
                 ("yi-6b", "decode_32k"), ("rwkv6-1.6b", "decode_32k"),
                 ("yi-6b", "prefill_32k"), ("h2o-danube-1.8b", "long_500k"),
                 ("h2o-danube-1.8b", "prefill_32k"))
# JAX's dot FLOPs a chip on the single-pod mesh, from its partitioned HLO
# (unrolled lowerings at 2 and 4 layers extrapolated to the full depth,
# 512 forced host devices on the CPU): `PYTHONPATH=src:. python
# tests/dryrun_parity.py --arch A --shape S --only jax --json out.jsonl`,
# its "walked_dot_flops" for h2o-danube long_500k (the batch-1 decode,
# whose dots JAX's own count drops as they end their fusions: 33423360).
# The port's count of a combo here may exceed it by DRYRUN_FLOPS_MARGIN
# at most
JAX_DOT_FLOPS = {("yi-6b", "prefill_32k"): 115723664359424.0,
                 ("h2o-danube-1.8b", "long_500k"): 47088640.0,
                 ("h2o-danube-1.8b", "prefill_32k"): 46643365314560.0}
DRYRUN_FLOPS_MARGIN = 1.10
# JAX's temporaries a chip on the single-pod mesh, the compiled step's
# memory_analysis() (full depth; same tool and run as JAX_DOT_FLOPS): the
# port's temp bytes of a combo here may exceed them by DRYRUN_TEMP_MARGIN
# at most. The dry-run counts the card's flash kernel in prefill (its
# op), not the plain version's score buffer
JAX_TEMP_BYTES = {("yi-6b", "prefill_32k"): 4303365488,
                  ("qwen3-moe-235b-a22b", "train_4k"): 72509044256,
                  ("h2o-danube-1.8b", "prefill_32k"): 1873166912}
DRYRUN_TEMP_MARGIN = 1.05


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


def captured(fn, calls: int, cpu: bool = False) -> list:
    """``kernel_events(fn, calls, cpu=cpu)``. A capture that took more
    than one attempt is logged, and kept in ``RESULTS["profiler_retries"]``,
    with its index among this run's captures, its attempts and the first
    kernels of the trace that was kept (which say what it profiled)."""
    from repro_torch.kernels.profiling import CAPTURES, kernel_events
    before = CAPTURES.copy()
    events = kernel_events(fn, calls, cpu=cpu)
    attempts = max((CAPTURES - before).keys())
    if attempts > 1:
        row = {"capture": sum(CAPTURES.values()), "calls": calls,
               "attempts": attempts,
               "kernels": sorted({e.key[:60] for e in events})[:4]}
        RESULTS.setdefault("profiler_retries", []).append(row)
        log({"phase": "profiler_retry", **row})
    return events


def device_ms(fn, marks: tuple[str, ...],
              calls: int = 20) -> tuple[float, int]:
    """(device time of one call of ``fn``, device kernels per call):
    ``calls`` back-to-back calls captured by ``captured`` (through
    ``kernel_events``, which takes the trace again while it holds no
    kernel event, and raises after ``ATTEMPTS`` empty ones); each kernel
    whose name contains one of ``marks`` counts its mean time per launch
    once for each launch per call, and every device kernel of any name
    counts towards the launches per call. The wrapper's host work is not
    in it (it is in the CUDA-event times, where it sets the pace at small
    shapes). The profiler drops events now and then (37 of 40 once; under
    half of a flash kernel's 20 once), so a kernel's launches per call
    are its count over ``calls``, rounded, and at least 1: every kernel
    in the trace ran in each call. A trace whose kernels carry none of
    ``marks`` raises: the mark names no kernel that ran."""
    from repro_torch.kernels.profiling import device_us
    fn()
    torch.cuda.synchronize()
    kern = [e for e in captured(fn, calls) if device_us(e) > 0]
    per_call = {e.key: max(1, round(e.count / calls)) for e in kern}
    us = sum(device_us(e) / e.count * per_call[e.key]
             for e in kern if any(m in e.key for m in marks))
    assert us > 0, f"no device kernel under {marks} in {sorted(per_call)}"
    return us / 1e3, sum(per_call.values())


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
    # library yardstick: torch.topk of the confidences with the rows the
    # select may not take (padding, at or above t_local) masked to +inf
    # (no -1 fill, no promised tie order: not the same function)
    rows_ = torch.arange(b, device=dev)
    masked = torch.where((rows_ < n_valid) & (conf < tt), conf, math.inf)
    select_lib = time_ms(lambda: torch.topk(masked, b, largest=False))
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
         "library_ms": select_lib,
         "library": "torch.topk(masked, B, largest=False)",
         "bound_ms": lb, "bound_by": lby},
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
    with the fp32 CUDA-core figure beside it; library: one addmm of the
    hidden, w and bias in w's dtype, a byte yardstick (not the same
    function)."""
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
    if w_dtype == torch.bfloat16:
        hb, bb = hd_.bfloat16(), bd_.bfloat16()
    else:
        hb, bb = hd_.float(), bd_
    lib_ms = time_ms(lambda: torch.addmm(bb, hb, wd_), samples=21, inner=3)
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
           "library": f"addmm(bias, hidden, w) in {str(wd_.dtype)[6:]}",
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


def kernel_ops_phase(dev) -> dict:
    """The three kernels the dry-run counts through their ops
    (``torch.ops.repro_torch.*``) against the real launches at their
    path shapes (yi-6b's serve window and last decode step, rwkv6's
    generate prefill): ``torch.library.opcheck``'s schema check (the
    scan writes ``s_out`` alone) and fake-tensor check (the fake
    implementation's output shape, dtype and strides against the
    launch's). Per call: the wrapper (the card's path: its dispatch, the
    launch and its count), the kernel function alone, and the op (the
    dispatcher on top of the launch)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan import ops as rops
    rng = np.random.default_rng(41)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)
    r, k, v, w, u, s0 = scan_inputs(dev, GEN_ROWS, GEN_PROMPT, 32, 64,
                                    torch.bfloat16, seed=42)
    s_out = torch.empty_like(s0)
    q, kc = mk(8, 48, 32, 128), [mk(8, 48, 4, 128) for _ in range(2)]
    qd, cache = mk(8, 32, 128), [mk(8, 544, 4, 128) for _ in range(2)]
    lens = torch.full((8,), 543, dtype=torch.int32, device=dev)
    cases = {
        "flash_attention": (fops.flash_attention_op, (q, *kc, True, 0),
                            lambda: fops.attention(q, *kc),
                            lambda: fk.flash_attention(q, *kc)),
        "decode_attention": (dops.decode_attention_op, (qd, *cache, lens),
                             lambda: dops.decode_attn(qd, *cache, lens),
                             lambda: dk.decode_attention(qd, *cache, lens)),
        "rwkv6_scan": (rops.rwkv6_scan_op, (r, k, v, w, u, s0, s_out),
                       lambda: rops.rwkv6_scan(r, k, v, w, u, s0, s_out),
                       lambda: rk.rwkv6_scan(r, k, v, w, u, s0, s_out))}
    out = {}
    with torch.no_grad():
        for name, (op, args, wrapper, launch) in cases.items():
            torch.library.opcheck(op, args, test_utils=("test_schema",
                                                         "test_faketensor"))
            inner = 3 if name == "rwkv6_scan" else 10
            row = {"op": f"repro_torch::{name}", "opcheck": "passed",
                   "wrapper_ms": time_ms(wrapper, inner=inner),
                   "kernel_ms": time_ms(launch, inner=inner),
                   "op_ms": time_ms(lambda: op(*args), inner=inner)}
            log({"phase": "kernel_ops", **row})
            out[name] = row
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
    if argv is SERVE_ARGV:      # yi-6b: serve_data_parallel compares
        PLAIN_SERVE.update(main=response_rows(res.responses),
                           fused=response_rows(res2.responses))
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
    from repro_torch.serving.generate import release_graphs
    release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)


def device_profile(fn) -> dict:
    """One call of ``fn`` (ending in a synchronize) under torch.profiler,
    CPU activity traced too (through ``captured``): its traced wall
    time, device (kernel) time by name and the device's busy share."""
    from repro_torch.kernels.profiling import device_us
    walls = []

    def timed():
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)

    events = captured(timed, calls=1, cpu=True)
    traced_ms = walls[-1]       # the capture whose trace was kept
    # kernel events only (an operator's device time repeats its kernels')
    kern = sorted(((e.key, device_us(e) / 1e3, e.count) for e in events
                   if device_us(e) > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kern)
    return {"traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / traced_ms,
            "top_kernels_ms": [[k, round(ms, 4), n] for k, ms, n in kern[:8]],
            "kernel_calls": {k: n for k, _, n in kern}}


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


# ----------------------------------------------------------------------------
# the fleet runtime: the tier ladder, the replica cluster, chaos injection
# ----------------------------------------------------------------------------

FLEET_REQUESTS, IDENTITY_REQUESTS = 256, 64
# every remote window's deadline, far above a window's first warm-up
FLEET_TIMEOUT = "transport.timeout_s=300"
CLUSTER_REPLICAS, CLUSTER_PROTOS, CLUSTER_STEP_S = 4, 96, 0.05
# benchmarks/cluster_bench.py's skew: hard rows mostly on r0/r1
HARD_W, EASY_W = (8.0, 4.0, 1.0, 1.0), (1.0, 2.0, 4.0, 7.0)
FLEET_SEED = 7


def launches_of(fn) -> tuple:
    """(fn's result, the kernel launches it made): every count set to 0
    just before and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def phase_numbers(dev, n: int, wall: float) -> dict:
    return {"requests": n, "wall_s": wall, "req_per_s": n / wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def billing_of(st) -> dict:
    from repro_torch.serving.engine import BILLING_FIELDS
    return {f: getattr(st, f) for f in BILLING_FIELDS}


def per_backend_of(st) -> dict:
    return {str(k): vars(v).copy() for k, v in st.per_backend.items()}


def serve_with_router(stack, cfg, router, n: int) -> tuple:
    """The stack's first ``n`` requests through an engine and scheduler
    built from ``cfg`` around ``router`` (as ``serve.run`` builds them,
    with no response cache); returns (responses by uid, engine, wall
    seconds)."""
    from repro_torch.serving import Request
    eng, sched = cfg.build(stack.local_apply, transport=router, cache=None,
                           fallback=lambda r: -1, device=stack.device)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            sched.submit(Request(
                uid=i, local_input=stack.local_toks[i],
                remote_input={"tokens": stack.toks[i] % stack.rcfg.vocab_size,
                              "idx": np.int32(i)}))
        responses = sched.flush()
    finally:
        eng.close()
    torch.cuda.synchronize()
    return (sorted(responses, key=lambda r: r.uid), eng,
            time.perf_counter() - t0)


def response_rows(responses) -> list:
    return [(r.uid, int(r.prediction), r.source, r.disposition, r.backend,
             r.cost) for r in responses]


def edge_threshold(stack) -> float:
    """A threshold halfway between the two middle remote confidences of
    the first 128 requests: the edge hop answers about half the rows it
    gets and escalates the rest to the cloud hop. (With the yi-6b oracle
    head every remote confidence is about 0.998, so the 0.6 of JAX's
    example ladder lets the edge hop answer every row, and the cloud hop
    never runs.)"""
    from repro_torch.core.supervisors import max_softmax
    conf = to_numpy(max_softmax(stack.remote_apply(
        {"tokens": stack.toks[:128] % stack.rcfg.vocab_size,
         "idx": np.arange(128)})))
    c = np.sort(conf.astype(np.float64))
    return float((c[63] + c[64]) / 2)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def serve_tiers_phase(dev, stack) -> dict:
    """The device -> edge -> cloud ladder through ``serve.run`` with
    ``--set tiers=edge:0.001:0.1:<t>;cloud:0.0048:0.8`` (JAX's example
    ladder, its edge threshold ``t`` set between the remote confidences),
    both hops the full-width yi-6b remote apply; then the degenerate
    2-stage identity: a terminal ``CascadeStage`` serves exactly as the
    plain ``RemoteBackend``."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.runtime import CascadeStage, RemoteBackend, RemoteRouter
    torch.cuda.reset_peak_memory_stats(dev)
    t_edge = edge_threshold(stack)
    tiers = f"tiers=edge:0.001:0.1:{t_edge!r};cloud:0.0048:0.8"
    args = serve.parse_args(SERVE_ARGV + ["--set", tiers,
                                          "--set", FLEET_TIMEOUT])
    cfg = stack.cfg.with_overrides([tiers, FLEET_TIMEOUT])
    res, counts = launches_of(
        lambda: serve.run(args, dataclasses.replace(stack, cfg=cfg)))
    n = args.requests
    main = serve_checks(res, n)
    st = res.engine.stats
    head = res.engine.router.candidates()[0]
    stages = head.chain()
    assert [s.name for s in stages] == ["edge", "cloud"]
    for s in stages:
        assert (s.stats.errors, s.stats.timeouts, s.stats.failed_requests,
                s.stats.short_circuited) == (0, 0, 0, 0), \
            f"stage {s.name}: {s.stats}"
    per = per_backend_of(st)
    # both hops answered rows, and each stage name's escalations reconcile
    assert set(per) == {"edge", "cloud"}, per
    assert all(u["remote_calls"] > 0 for u in per.values()), per
    assert {r.backend for r in res.responses if r.backend} == {"edge",
                                                               "cloud"}
    windows = {s.name: s.stats.windows for s in stages}
    want = attention_layers(stack.rcfg) * sum(windows.values())
    assert counts["flash_attention"] == want, \
        f"flash_attention: {counts['flash_attention']} launches, not {want}"
    assert counts["gate_score"] > 0 and counts["gate_select"] > 0
    assert counts["decode_attention"] == 0
    out = {"t_edge": t_edge, "main": main, "launches": counts,
           "stage_windows": windows,
           "stage_stats": {s.name: vars(s.stage_stats).copy()
                           for s in stages},
           "per_backend": per,
           **phase_numbers(dev, n, res.wall_s)}

    # the degenerate 2-stage identity, over 64 requests
    base = stack.cfg.with_overrides([FLEET_TIMEOUT])
    runs = {}
    for cls in (RemoteBackend, CascadeStage):
        router = RemoteRouter([cls("remote", stack.remote_apply,
                                   base.transport)],
                              policy=base.route_policy)
        (rows, eng, wall), c = launches_of(lambda: serve_with_router(
            stack, base, router, IDENTITY_REQUESTS))
        runs[cls.__name__] = {"responses": response_rows(rows),
                              "billing": billing_of(eng.stats),
                              "per_backend": per_backend_of(eng.stats),
                              "flash": c["flash_attention"], "wall_s": wall}
    plain, stage = runs["RemoteBackend"], runs["CascadeStage"]
    for key in ("responses", "billing", "per_backend", "flash"):
        assert plain[key] == stage[key], f"2-stage identity: {key} differs"
    assert plain["flash"] > 0
    out["identity"] = {"requests": IDENTITY_REQUESTS,
                       "billing": plain["billing"], "flash": plain["flash"],
                       "wall_s": [plain["wall_s"], stage["wall_s"]]}
    log({"phase": "serve_tiers", **out})
    return out


def cluster_workload(stack, n: int) -> tuple:
    """``n`` requests over ``CLUSTER_PROTOS`` prototype rows of the task
    (so content keys recur across replicas), each assigned to a replica
    by a seeded draw weighted by its difficulty: hard rows (local
    confidence below the median) mostly to r0/r1, easy rows to r2/r3.
    Returns (prototype per request, replica per request)."""
    from repro_torch.core.supervisors import max_softmax
    rng = np.random.default_rng(FLEET_SEED + 13)
    proto = rng.integers(0, CLUSTER_PROTOS, n)
    conf = to_numpy(max_softmax(stack.local_apply(torch.as_tensor(
        stack.local_toks[:CLUSTER_PROTOS], device=stack.device))))
    hard = conf < np.median(conf)
    hw = np.asarray(HARD_W) / sum(HARD_W)
    ew = np.asarray(EASY_W) / sum(EASY_W)
    assign = [f"r{rng.choice(CLUSTER_REPLICAS, p=hw if hard[j] else ew)}"
              for j in proto]
    return proto, assign


def cluster_run(stack, cfg, proto, assign) -> dict:
    """One fleet run on a fresh virtual clock, router and harness: request
    i (prototype ``proto[i]``) to replica ``assign[i]``, the clock
    ``CLUSTER_STEP_S`` on per request, every replica flushed each 32
    requests per replica."""
    from repro_torch.runtime import ClusterHarness, VirtualClock
    from repro_torch.runtime.cache import content_key, content_keys
    from repro_torch.serving import Request
    clock = VirtualClock()
    router = cfg.build_router(stack.remote_apply, clock=clock,
                              sleep=clock.sleep)
    h = ClusterHarness(
        cfg, stack.local_apply, transport=router, fallback=lambda r: -1,
        clock=clock, seed=FLEET_SEED, reconcile_interval_s=2.0,
        cache_key_fn=lambda row: content_key(row["tokens"]),
        cache_key_batch_fn=lambda b, k: content_keys(b["tokens"], k),
        device=stack.device)
    responses = []
    t0 = time.perf_counter()
    every = cfg.batch_size * CLUSTER_REPLICAS
    for i, (j, name) in enumerate(zip(proto, assign)):
        clock.advance_to(CLUSTER_STEP_S * i)
        h.submit(name, Request(
            uid=i, local_input=stack.local_toks[j],
            remote_input={"tokens": stack.toks[j] % stack.rcfg.vocab_size,
                          "idx": np.int32(j)}))
        if (i + 1) % every == 0:
            for batch in h.flush().values():
                responses.extend(batch)
    for batch in h.flush().values():
        responses.extend(batch)
    h.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"harness": h, "wall_s": wall,
            "responses": sorted(responses, key=lambda r: r.uid)}


def cluster_digest(run) -> tuple[dict, dict]:
    """(integer outputs, float outputs) of a fleet run."""
    h = run["harness"]
    ints = {
        "responses": [(r.uid, int(r.prediction), r.source, r.disposition,
                       r.backend) for r in run["responses"]],
        "billing": {n: {f: v for f, v in billing_of(
            h.replica(n).engine.stats).items() if f != "total_cost"}
            for n in h.names},
        "reconciles": h.cluster.state.reconciles,
        "feed": [(u.key.hex(), u.source, u.replica)
                 for u in h.shared_cache.feed],
        "shared_cache": vars(h.shared_cache.stats).copy(),
    }
    floats = {
        "local_conf": [r.local_conf for r in run["responses"]],
        "remote_conf": [r.remote_conf for r in run["responses"]],
        "cost": [r.cost for r in run["responses"]],
        "targets": [h.cluster.target(n) for n in h.names],
        "total_cost": [h.replica(n).engine.stats.total_cost
                       for n in h.names],
    }
    return ints, floats


def fleet_checks(stack, h, responses, n: int, counts: dict) -> dict:
    """The invariants of a fleet run of ``n`` requests through harness
    ``h``: every uid answered once, single fill (no duplicate fill, a
    feed of unique keys), each remote call a fill or a redundant put, the
    replicas' billing summing to ``cluster_billing``, each replica's
    escalations reconciled with no transport failure, and 32 flash
    launches per remote window with the gate kernels launched. Returns
    the run's numbers."""
    from repro_torch.runtime import cluster_billing
    from repro_torch.serving.engine import BILLING_FIELDS
    assert sorted(r.uid for r in responses) == list(range(n)), \
        f"answered {len(responses)} of {n} requests, or one twice"
    scs = h.shared_cache.stats
    assert scs.duplicate_fills == 0, scs
    keys = [u.key for u in h.shared_cache.feed]
    assert len(keys) == len(set(keys)), "a key filled twice"
    fleet = h.global_billing()
    b = fleet["billing"]
    assert b["requests"] == n
    assert b["remote_calls"] == scs.fills + scs.redundant_puts, (b, scs)
    stats = {name: h.replica(name).engine.stats for name in h.names}
    for f in BILLING_FIELDS:
        total = sum(getattr(st, f) for st in stats.values())
        assert math.isclose(b[f], total, rel_tol=1e-12, abs_tol=1e-12), f
    assert fleet == cluster_billing(stats)
    for st in stats.values():
        assert st.escalations == st.remote_calls + st.cache_hits \
            + st.transport_failures
        assert st.transport_failures == 0, st
    windows = sum(bk.stats.windows for bk in h.router)
    assert counts["flash_attention"] == \
        attention_layers(stack.rcfg) * windows, \
        (counts["flash_attention"], windows)
    assert counts["gate_score"] > 0 and counts["gate_select"] > 0
    return {"billing": b,
            "cross_hits": sum(h.replica(name).cache.stats.cross_hits
                              for name in h.names),
            "remote_windows": windows,
            "reconciles": h.cluster.state.reconciles,
            "mode": h.cluster.state.mode,
            "targets": {name: h.cluster.target(name) for name in h.names},
            "shared_cache": vars(scs).copy(), "launches": counts,
            "per_replica_requests": {name: st.requests for name, st
                                     in stats.items()}}


def serve_cluster_phase(dev, stack) -> dict:
    """4 replicas behind one logical cascade, one router over the
    full-width yi-6b remote and one shared response cache. First through
    the entry point (``serve.run`` with ``--set replicas=4 --adaptive``:
    round-robin, wall-clock reconciles); then twice on a virtual clock
    with 256 requests of skewed traffic whose contents recur across
    replicas, and the two runs agree bit for bit."""
    import dataclasses

    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats(dev)
    n = FLEET_REQUESTS
    sets = [f"replicas={CLUSTER_REPLICAS}", FLEET_TIMEOUT]
    args = serve.parse_args(SERVE_ARGV + ["--adaptive"] + sum(
        (["--set", x] for x in sets), []))
    cfg = stack.cfg.with_overrides(sets + ["adaptive=True"])
    res, counts = launches_of(
        lambda: serve.run(args, dataclasses.replace(stack, cfg=cfg)))
    h = res.harness
    assert res.engine is None and h is not None
    entry = fleet_checks(stack, h, res.responses, args.requests, counts)
    assert entry["reconciles"] >= 1     # the run's closing reconcile
    assert set(entry["per_replica_requests"].values()) == \
        {args.requests // CLUSTER_REPLICAS}
    entry.update(phase_numbers(dev, args.requests, res.wall_s))

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = stack.cfg.with_overrides([
        f"replicas={CLUSTER_REPLICAS}", "adaptive=True",
        "control_window=32", "observability=True", FLEET_TIMEOUT])
    proto, assign = cluster_workload(stack, n)
    runs = []
    for _ in range(2):
        run, counts = launches_of(
            lambda: cluster_run(stack, cfg, proto, assign))
        row = fleet_checks(stack, run["harness"], run["responses"], n,
                           counts)
        assert row["cross_hits"] > 0, "no hit across replicas"
        row.update(wall_s=run["wall_s"], req_per_s=n / run["wall_s"])
        run["row"] = row
        runs.append(run)
    (ia, fa), (ib, fb) = (cluster_digest(r) for r in runs)
    assert ia == ib, "the two fleet runs differ in an integer output"
    # the card replays bit for bit: each sum runs in one order in both
    # runs, so a float that differs is a loss of determinism
    for k in fa:
        assert fa[k] == fb[k], f"the two fleet runs differ in {k}"
    out = {"replicas": CLUSTER_REPLICAS, "protos": CLUSTER_PROTOS,
           "entry_point": entry, "runs": [r["row"] for r in runs],
           "bitwise_replay": True,
           **phase_numbers(dev, n, runs[0]["wall_s"])}
    log({"phase": "serve_cluster", **out})
    return out


def chaos_run(stack, cfg, mode: str) -> dict:
    """The stack's 256 requests through ``cfg``'s router under a 50%
    brownout of every call (``ChaosEpisode("brownout", 0, 1e9, rate=0.5)``,
    seeded), in completion mode ``mode``. Each backend's remote apply is
    wrapped outside the chaos wrapper to count the exceptions it raises
    and whether each carries its episode's ``chaos[...]`` tag."""
    import dataclasses

    from repro_torch.runtime import ChaosEpisode, ChaosSchedule
    cfg = dataclasses.replace(cfg, completion_mode=mode)
    router = cfg.build_router(stack.remote_apply)
    schedule = ChaosSchedule([ChaosEpisode("brownout", 0.0, 1e9, rate=0.5,
                                           name="brownout")],
                             seed=FLEET_SEED)
    schedule.wrap_router(router)
    raised = {"tagged": 0, "untagged": 0}

    def tally(inner):
        def call(batch):
            try:
                return inner(batch)
            except Exception as e:
                raised["tagged" if "chaos[brownout]" in str(e)
                       else "untagged"] += 1
                raise
        return call

    for b in router:
        b.transport.remote_apply = tally(b.transport.remote_apply)
    (rows, eng, wall), counts = launches_of(lambda: serve_with_router(
        stack, cfg, router, FLEET_REQUESTS))
    return {"responses": rows, "engine": eng, "router": router,
            "schedule": schedule, "raised": raised, "launches": counts,
            "wall_s": wall}


def serve_chaos_phase(dev, stack) -> dict:
    """The yi-6b router under a seeded 50% brownout, served in fifo and in
    streaming completion with two windows in flight: every failure is an
    injected one, billing reconciles, and the two modes bill alike. The
    transport runs with one pool worker, so the two in-flight windows
    reach the chaos wrapper in the order they were submitted (with more
    workers they race, and the count-indexed draws can land on other
    windows in the two modes); it neither retries nor opens its breaker,
    so each failed window is one injected fault."""
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = stack.cfg.with_overrides([
        "pipeline_depth=2", FLEET_TIMEOUT, "transport.max_retries=0",
        "transport.breaker_failures=1000000", "transport.max_concurrent=1"])
    out = {}
    digests = {}
    for mode in ("fifo", "streaming"):
        run = chaos_run(stack, cfg, mode)
        rows, st, sch = response_rows(run["responses"]), \
            run["engine"].stats, run["schedule"].stats
        n = FLEET_REQUESTS
        assert [r[0] for r in rows] == list(range(n)), \
            f"{mode}: answered {len(rows)} of {n} requests, or one twice"
        errors = sum(b.stats.errors for b in run["router"])
        assert sum(b.stats.timeouts for b in run["router"]) == 0
        assert run["raised"]["untagged"] == 0, run["raised"]
        assert run["raised"]["tagged"] == sch.injected == errors > 0, \
            (run["raised"], sch.injected, errors)
        assert sch.by_episode == {"brownout": sch.injected}
        assert st.transport_failures > 0
        assert st.escalations == st.remote_calls + st.cache_hits \
            + st.transport_failures
        # every fallback is counted in ``rejected``: a row lost to the
        # transport (billed nothing) or a billed answer the 2nd supervisor
        # refused
        falls = [r for r in rows if r[2] == "fallback"]
        fallbacks = len(falls)
        lost = sum(r[5] == 0.0 for r in falls)
        assert fallbacks == st.rejected, (fallbacks, st.rejected)
        assert lost == st.transport_failures, (lost, st.transport_failures)
        assert math.isclose(st.total_cost, sum(
            u.cost for u in st.per_backend.values()), rel_tol=1e-9,
            abs_tol=1e-12)
        counts = run["launches"]
        calls = sch.calls - sch.injected        # windows that reached yi-6b
        assert counts["flash_attention"] == \
            attention_layers(stack.rcfg) * calls, \
            (counts["flash_attention"], calls)
        assert counts["gate_score"] > 0 and counts["gate_select"] > 0
        digests[mode] = {"responses": [r[:3] for r in rows],
                         "billing": billing_of(st),
                         "per_backend": per_backend_of(st),
                         "chaos": vars(sch).copy()}
        out[mode] = {"billing": billing_of(st), "chaos": vars(sch).copy(),
                     "fallbacks": fallbacks, "launches": counts,
                     **phase_numbers(dev, n, run["wall_s"])}
    for key in ("responses", "billing", "per_backend", "chaos"):
        assert digests["fifo"][key] == digests["streaming"][key], \
            f"fifo and streaming differ in {key}"
    log({"phase": "serve_chaos", **out})
    return out


# ----------------------------------------------------------------------------
# early emit and the gate triple's non-blocking fetch; the six examples
# ----------------------------------------------------------------------------

EMIT_SETS = ["batching=continuous", "completion_mode=streaming",
             "pipeline_depth=2", "observability=True", FLEET_TIMEOUT]
PROFILED_REQUESTS = 64          # the profiled continuous run: 2 windows


def remote_window_ms(router) -> float | None:
    """Mean latency of a transport window (at most 8 rows) over the
    router's backends, in ms."""
    lat = [b.stats.mean_latency_s for b in router
           if b.stats.mean_latency_s is not None]
    return float(np.mean(lat)) * 1e3 if lat else None


def quantiles_ms(xs: list) -> dict:
    if not xs:
        return {"n": 0, "p50_ms": None, "p99_ms": None}
    a = np.asarray(xs, dtype=np.float64) * 1e3
    return {"n": len(xs), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def early_emit_run(stack, cfg, early_emit: bool, n: int) -> dict:
    """The stack's first ``n`` requests through the continuous batcher of
    ``cfg`` (observability on, no response cache), early emit on or off.
    Stamps when each window's triple reached the emitter's callback; the
    spans give each window's dispatch and gate stamps and each row's
    enqueue and hand-back."""
    from repro_torch.serving import CascadeEngine, CostModel, Request
    router = cfg.build_router(stack.remote_apply)
    # what from_config builds from cfg (no controller, no cache), with
    # early emit set rather than picked by the batching mode
    assert cfg.build_controller() is None
    eng = CascadeEngine(
        stack.local_apply, batch_size=cfg.batch_size,
        remote_fraction_budget=cfg.remote_fraction_budget,
        t_remote=cfg.t_remote, cost=cfg.cost or CostModel(),
        supervisor=cfg.supervisor, transport=router,
        default_policy=cfg.default_policy,
        observability=cfg.build_observability(), early_emit=early_emit,
        device=stack.device)
    if cfg.t_local is not None:
        eng.set_local_threshold(cfg.t_local)
    sched = cfg.build_scheduler(eng, fallback=lambda r: -1)
    assert eng.early_emit == early_emit
    landed = {}
    if early_emit:
        inner = eng._emitter._emit

        def stamped(seq, *triple):
            landed[seq] = time.perf_counter()
            inner(seq, *triple)

        eng._emitter._emit = stamped
    t0 = time.perf_counter()
    try:
        for i in range(n):
            sched.submit(Request(
                uid=i, local_input=stack.local_toks[i],
                remote_input={"tokens": stack.toks[i] % stack.rcfg.vocab_size,
                              "idx": np.int32(i)}))
        responses = sched.flush()
    finally:
        eng.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = eng.observability.trace.spans()
    windows = eng._seq
    assert eng._gate_emits == (windows if early_emit else 0), \
        (eng._gate_emits, windows)
    assert eng._gate_results == {}, sorted(eng._gate_results)
    assert eng._emitter is None or not eng._emitter.alive
    stamps = {}
    for sp in spans:
        st = dict(sp["stages"])
        stamps[sp["window"]] = (st["dispatch"], st["gate"])
    locals_ = [sp["stages"][-1][1] - sp["stages"][0][1] for sp in spans
               if sp["disposition"] == "LOCAL"]
    wait_lag = [g - d for d, g in stamps.values()]
    emit_lag = [landed[w] - d for w, (d, _) in stamps.items()
                if w in landed]
    taken = sum(landed[w] <= g for w, (_, g) in stamps.items()
                if w in landed)
    return {"responses": response_rows(sorted(responses,
                                              key=lambda r: r.uid)),
            "billing": billing_of(eng.stats),
            "per_backend": per_backend_of(eng.stats),
            "remote_ms": remote_window_ms(router),
            "windows": windows, "emits": eng._gate_emits,
            "wall_s": wall, "req_per_s": n / wall,
            "trusted_local_handback": quantiles_ms(locals_),
            "dispatch_to_host_half_triple": quantiles_ms(wait_lag),
            "dispatch_to_emit": quantiles_ms(emit_lag),
            "emitted_before_host_half": taken}


def kernel_timeline(fn) -> tuple[list, float]:
    """One call of ``fn`` (ending in a synchronize) under torch.profiler:
    its device kernels as (name, stream, start us, end us) from the
    exported trace, and the traced wall time in ms. A trace with no
    kernel is taken again after the profiling module's pause, as
    ``kernel_events`` does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.profiling import ATTEMPTS, RETRY_PAUSE_S
    path = ROOT / "build" / "early_emit_trace.json"
    path.parent.mkdir(exist_ok=True)
    for attempt in range(1, ATTEMPTS + 1):
        if attempt > 1:
            time.sleep(RETRY_PAUSE_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        kern = [(e["name"], e.get("args", {}).get("stream"), e["ts"],
                 e["ts"] + e.get("dur", 0)) for e in events
                if e.get("cat") == "kernel"]
        if kern:
            if attempt > 1:
                RESULTS.setdefault("profiler_retries", []).append(
                    {"timeline": True, "attempts": attempt})
            return kern, wall_ms
    raise RuntimeError(f"no kernel traced in {ATTEMPTS} captures")


def union_us(spans: list) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def overlap_profile(stack, cfg) -> dict:
    """One profiled continuous run of two windows with early emit on: the
    device's busy share, the streams the gate kernels (the local step)
    and flash attention (the remote prefill) ran on, and how long kernels
    of the two ran at once."""
    def run():
        early_emit_run(stack, cfg, True, PROFILED_REQUESTS)

    run()                               # warm
    kern, wall_ms = kernel_timeline(run)
    local_streams = {s for n, s, _, _ in kern
                     if "vocab_stats" in n or "gate_select" in n}
    remote_streams = {s for n, s, _, _ in kern if "flash" in n}
    assert local_streams and remote_streams, (local_streams, remote_streams)
    loc = [(a, b) for n, _, a, b in kern
           if "vocab_stats" in n or "gate_select" in n]
    rem = [(a, b) for n, _, a, b in kern if "flash" in n]
    both = union_us(loc) + union_us(rem) - union_us(loc + rem)
    busy = union_us([(a, b) for _, _, a, b in kern])
    t0 = min(a for _, _, a, _ in kern)
    t1 = max(b for _, _, _, b in kern)
    return {"requests": PROFILED_REQUESTS, "traced_wall_ms": wall_ms,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "kernel_span_ms": (t1 - t0) / 1e3,
            "local_streams": sorted(map(str, local_streams)),
            "remote_streams": sorted(map(str, remote_streams)),
            "local_kernels": len(loc), "remote_kernels": len(rem),
            "local_remote_overlap_ms": both / 1e3,
            "overlap": both > 0}


def serve_early_emit_phase(dev, stack) -> dict:
    """The yi-6b serve stack's 256 requests through the continuous batcher
    (streaming, pipeline depth 2), early emit off, on, off, on; then the
    same with one transport worker (off, on), so remote windows are
    launched from one thread at a time; then the plain window path and
    the streaming window drain at depth 2. Every run answers alike and
    bills alike (a cacheless continuous run bills as the window drain),
    with the same kernel launches; each early-emit run has one emit per
    dispatched window and none left stored. Each run's req/s and mean
    remote window latency; the continuous runs' trusted-local hand-back
    and the lag from dispatch to the triple on the host (the emitter's
    and the host half's); one profiled continuous run."""
    torch.cuda.reset_peak_memory_stats(dev)
    n = FLEET_REQUESTS
    runs = []
    for workers, flags in ((None, (False, True, False, True)),
                           (1, (False, True))):
        cfg = stack.cfg.with_overrides(EMIT_SETS + (
            [f"transport.max_concurrent={workers}"] if workers else []))
        for flag in flags:
            run, counts = launches_of(lambda: early_emit_run(
                stack, cfg, flag, n))
            run.update(early_emit=flag, launches=counts,
                       transport_workers=cfg.transport.max_concurrent)
            assert [r[0] for r in run["responses"]] == list(range(n))
            assert counts["gate_score"] == run["windows"] > 0
            assert counts["gate_select"] == run["windows"]
            runs.append(run)
    base = stack.cfg.with_overrides([FLEET_TIMEOUT])
    drains = {}
    for name, drain in (("window", base), ("streaming_window",
                        base.with_overrides(["pipeline_depth=2",
                                             "completion_mode=streaming"]))):
        router = drain.build_router(stack.remote_apply)
        (rows, eng, wall), counts = launches_of(lambda: serve_with_router(
            stack, drain, router, n))
        assert not eng.early_emit
        drains[name] = {"responses": response_rows(rows),
                        "billing": billing_of(eng.stats),
                        "per_backend": per_backend_of(eng.stats),
                        "launches": counts, "req_per_s": n / wall,
                        "wall_s": wall,
                        "remote_ms": remote_window_ms(router)}
    for r in runs[1:] + list(drains.values()):
        for key in ("responses", "billing", "per_backend", "launches"):
            assert r[key] == runs[0][key], f"a run differs in {key}"
    out = {"requests": n, "windows": runs[0]["windows"],
           "billing": runs[0]["billing"], "launches": runs[0]["launches"],
           "runs": [{k: r[k] for k in (
               "early_emit", "transport_workers", "req_per_s", "wall_s",
               "remote_ms", "emits", "trusted_local_handback",
               "dispatch_to_host_half_triple", "dispatch_to_emit",
               "emitted_before_host_half")}
               for r in runs],
           **{name: {k: d[k] for k in ("req_per_s", "wall_s", "remote_ms")}
              for name, d in drains.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    out["profile"] = overlap_profile(stack,
                                     stack.cfg.with_overrides(EMIT_SETS))
    log({"phase": "serve_early_emit", **out})
    return out


EXAMPLE_ARGV = {"train_surrogate": [
    "--scale", "100m", "--steps", "50",
    "--checkpoint", str(ROOT / "build" / "surrogate_ckpt.msgpack")]}


def examples_phase(dev) -> dict:
    """Each of ``repro_torch.examples`` through its ``main`` on the card,
    in process, with its own assertions: the training example at the
    ~100M-parameter scale for 50 steps (its loss must fall), the others
    at the JAX examples' sizes. Records each one's seconds and kernel
    launches."""
    import importlib
    out = {}
    for name in ("quickstart", "serve_cascade", "adaptive_cascade",
                 "observability_demo", "train_surrogate",
                 "generate_long_context"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        res, counts = launches_of(lambda: mod.main(
            ["--device", dev.type] + EXAMPLE_ARGV.get(name, [])))
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": {k: v for k, v in counts.items() if v}}
        if name == "generate_long_context":
            assert counts["rwkv6_scan"] > 0 and counts["maxconf"] > 0
            out[name]["conf_min"] = res["conf_min"].tolist()
        elif name == "train_surrogate":
            assert res["ce_last"] < res["ce_first"]
            out[name].update(ce_first=res["ce_first"], ce_last=res["ce_last"])
        elif name in ("adaptive_cascade", "observability_demo"):
            assert counts["gate_score"] > 0 and counts["gate_select"] > 0
    log({"phase": "examples", **out})
    return out


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
    Times the decode steps as the main path runs them, profiles one
    (on GRAPH_ARCHS the graph's replay, whose decode-attention launches
    the device trace counts), and applies the 2nd supervisor
    (seq_min_likelihood) to the answers. On GRAPH_ARCHS it then times
    MISS_CALLS calls on prompts one to MISS_CALLS tokens shorter, each a
    new graph key, against the eager loop on the same prompts (the same
    tokens and likelihoods, bit for bit) and a second call of the last
    key."""
    from repro_torch.core.supervisors import seq_min_likelihood
    from repro_torch.core.thresholds import nominal_quantile_threshold
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.maxconf.ops import maxconf
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import frontend_embeddings
    from repro_torch.runtime.observability import SPANS
    from repro_torch.serving.generate import (decode_graph, graft,
                                              greedy_generate)
    cfg, params = stack.rcfg, stack.rparams
    n_l, n_attn = cfg.num_layers, attention_layers(cfg)
    prompt = np.random.default_rng(25).integers(
        1, cfg.vocab_size, (rows, prompt_len - patches))
    batch = {"tokens": prompt}
    if patches:
        batch["embeds"] = frontend_embeddings(cfg, rows, patches, seed=25,
                                              device=dev)
    # warm-up at the timed call's shape (cuBLAS plans; on the graph path
    # the capture), so that the timed call replays every step
    t0 = time.perf_counter()
    greedy_generate(cfg, params, batch, GEN_TOKENS)
    torch.cuda.synchronize(dev)
    first_call_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path
    reset_launch_counts()
    graph_steps = SPANS.counter("generate_decode_steps_total", path="graph")
    before = graph_steps.value
    t0 = time.perf_counter()
    toks, liks = greedy_generate(cfg, params, batch, GEN_TOKENS)
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    graphed = cfg.name in GRAPH_ARCHS
    assert graph_steps.value - before == (GEN_TOKENS - 1) * graphed, \
        f"{graph_steps.value - before} graph steps, graph path {graphed}"
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
        eager_ms = step_ms

        if graphed:     # the step as the main path runs it: a replay
            graph = decode_graph(cfg, params, rows, prompt_len + GEN_TOKENS,
                                 dev)
            step_ms = []
            for i in range(GEN_TOKENS - 1):
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                graph.replay(prompt_len + i)
                torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t1) * 1e3)

        def one_step():
            if graphed:
                graph.replay(prompt_len + GEN_TOKENS - 2)
            else:
                with torch.no_grad():
                    lg, _ = T.decode_step(cfg, params, toks[:, -2], cache,
                                          prompt_len + GEN_TOKENS - 2)
                    maxconf(lg)
            torch.cuda.synchronize(dev)

        profile = device_profile(one_step)
        if graphed:     # the device ran the replay's kernels
            split = sum(n for k, n in profile["kernel_calls"].items()
                        if "decode_split_kernel" in k)
            assert split == n_attn, f"{split} decode kernels in a replay"

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

    misses = miss_calls(cfg, params, batch) if graphed else {}
    conf = seq_min_likelihood(liks).cpu().numpy()
    t_remote = nominal_quantile_threshold(conf, 0.25)
    med_ms = statistics.median(step_ms)
    slots = prompt_len + GEN_TOKENS
    if cfg.sliding_window:
        slots = min(slots, cfg.sliding_window)
    out = {"phase": "generate", "config": cfg.name, "layers": n_l,
           "rows": rows, "prompt": prompt_len, "patches": patches,
           "new_tokens": GEN_TOKENS, "graph_path": graphed,
           "first_call_s": first_call_s, "wall_s": wall_s,
           "tokens_per_s_end_to_end": rows * GEN_TOKENS / wall_s,
           "decode_step_ms_median": med_ms,
           "decode_step_ms_range": [min(step_ms), max(step_ms)],
           "eager_step_ms_median": statistics.median(eager_ms), **misses,
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


def eager_generate(cfg, params, batch: dict, n: int):
    """``greedy_generate`` through its eager loop (the CPU's path), on the
    card: (tokens, likelihoods)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import generate as G
    with torch.no_grad():
        logits, pcache = T.prefill(cfg, params, batch)
        tok, lik = G._pick(logits)
        b = logits.shape[0]
        t = sum(batch[k].shape[1] for k in ("embeds", "tokens") if k in batch)
        cache = G.graft(T.make_cache(cfg, b, t + n, logits.device), pcache)
        return G._decode_eager(cfg, params, tok, lik, cache, t, n - 1)


def miss_calls(cfg, params, batch: dict) -> dict:
    """What a new graph key costs: MISS_CALLS generate calls on prompts
    1..MISS_CALLS tokens shorter than ``batch``'s (each key new: its
    first step eager, then the capture), the eager loop on each (the same
    tokens and likelihoods, bit for bit), and the last key's second call
    (every step a replay); host seconds, each call ending in a
    synchronize."""
    from repro_torch.serving.generate import greedy_generate

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    miss, eager = [], []
    for k in range(1, MISS_CALLS + 1):
        sub = {**batch, "tokens": batch["tokens"][:, k:]}
        got, s = timed(lambda: greedy_generate(cfg, params, sub, GEN_TOKENS))
        miss.append(s)
        want, s = timed(lambda: eager_generate(cfg, params, sub, GEN_TOKENS))
        eager.append(s)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"{cfg.name}: the graph path's call {k} is not the eager loop's"
    _, hit = timed(lambda: greedy_generate(cfg, params, sub, GEN_TOKENS))
    return {"miss_call_s": miss, "miss_eager_call_s": eager,
            "miss_hit_call_s": hit}


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


def serve_data_parallel_phase(dev, stack) -> dict:
    """The serve phase's 256 requests (and the 64 of its fused-head
    branch) through ``serve.run`` with ``data_parallel=True``: the local
    forward on a (1, 1) serving mesh of an NCCL group of one
    (``launch.mesh.make_serving_mesh``), its rows as DTensors, gathered
    before the gate. Every response, the bill and the gate, head-gate and
    flash launches must equal the plain serve phase's; req/s and the
    remote window latency beside the plain phase's."""
    from repro_torch.kernels.fused_head_gate.ops import FusedLocalHead
    from repro_torch.launch import serve
    from repro_torch.models import surrogate as S

    args = serve.parse_args(SERVE_ARGV)
    plain_cfg = stack.cfg
    stack.cfg = dataclasses.replace(plain_cfg, data_parallel=True)

    @torch.no_grad()
    def trunk(tk):
        return S.apply(stack.scfg, stack.sparams, tk, return_hidden=True)[1]

    head = FusedLocalHead(trunk, stack.sparams["out"]["w"],
                          stack.sparams["out"]["b"])
    try:
        res, counts = launches_of(lambda: serve.run(args, stack))
        res2, counts2 = launches_of(lambda: serve.run(
            args, stack, local_apply=head, requests=FUSED_REQUESTS))
    finally:
        stack.cfg = plain_cfg
    mesh = res.engine.mesh
    assert mesh is not None and dict(mesh.shape) == {"data": 1, "model": 1}
    main, fused = serve_checks(res, args.requests), serve_checks(
        res2, FUSED_REQUESTS)
    plain = RESULTS["phases"]["serve"]
    assert response_rows(res.responses) == PLAIN_SERVE["main"], \
        "the serving mesh changed a response"
    assert response_rows(res2.responses) == PLAIN_SERVE["fused"], \
        "the serving mesh changed a fused-head response"
    assert main["billing"] == plain["main"]["billing"]
    assert fused["billing"] == plain["fused_head"]["billing"]
    assert counts == plain["main"]["launches"], counts
    assert counts2 == plain["fused_head"]["launches"], counts2
    out = {"mesh": dict(mesh.shape), "requests": args.requests,
           "launches": counts, "fused_head_launches": counts2,
           "billing": main["billing"],
           "req_per_s": main["req_per_s"],
           "plain_req_per_s": plain["main"]["req_per_s"],
           "remote_window_ms": main["remote_prefill_ms_per_window"],
           "plain_remote_window_ms": plain["main"][
               "remote_prefill_ms_per_window"],
           "fused_req_per_s": fused["req_per_s"],
           "plain_fused_req_per_s": plain["fused_head"]["req_per_s"]}
    log({"phase": "serve_data_parallel", **out})
    return out


def train_mesh_phase(dev, plain: dict, arch: str = "yi-6b",
                     steps: int = 6) -> dict:
    """``launch.train --mesh 1,1``: the ``train`` phase's model, batch
    stream and schedule (its ``--steps``) on an NCCL group of one,
    parameters, moments and batches as DTensors, for its first
    ``steps`` steps (the stream's first batches): losses equal to the
    train phase's first ones within the train path's tolerance (rtol
    1e-5), no kernel launched, step time and peak memory beside the
    train phase's (whose peak also holds its all-leaf gradient check)."""
    from repro_torch.launch import train
    free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    args = train.parse_args(["--arch", arch, "--steps", str(plain["steps"]),
                             "--mesh", "1,1"])
    cfg, params, opt_state, step_fn = train.setup(args)
    batches = train.make_batches(cfg, args.batch, args.seq)
    losses, step_s = [], []

    def run():
        nonlocal params, opt_state
        for _ in range(steps):
            batch = train.to_device(next(batches), dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)

    _, counts = launches_of(run)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del params, opt_state, step_fn
    free(dev)
    assert sum(counts.values()) == 0, counts
    assert all(math.isfinite(x) for x in losses), losses
    want = plain["loss"][:steps]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    out = {"arch": arch, "mesh": {"data": 1, "model": 1}, "steps": steps,
           "losses": losses, "plain_losses": want,
           "max_rel_loss_diff": max(abs(a - b) / abs(b)
                                    for a, b in zip(losses, want)),
           "step_s_median": statistics.median(step_s[1:]),
           "plain_step_s_median": plain["step_s_median"],
           "peak_mem_gib": peak, "plain_peak_mem_gib": plain["peak_mem_gib"]}
    log({"phase": "train_mesh", **out})
    return out


def roofline_phase(measured: dict) -> dict:
    """``analysis.roofline`` on one chip (fake tensors on the CPU: the
    plain paths' ops counted, nothing allocated) for the card's own
    paths: the compute term, the memory term (the bytes the step must
    move), the bound (the larger) and the plain path's unfused traffic,
    each beside its median measured in this run and the hand bound
    PERF.md §2 worked out (the card's constants; TF32 off, as this run
    sets it)."""
    from repro_torch.analysis.roofline import (bound_step_time,
                                               roofline_from_lowered)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import lower_step
    rows = {}
    for name, (arch, kind, b, t) in ROOFLINE_PATHS.items():
        cfg, shape = get_config(arch), ShapeConfig(name, t, b, kind)
        t0 = time.perf_counter()
        rec = roofline_from_lowered(lower_step(cfg, shape, make_host_mesh()),
                                    cfg, shape, make_host_mesh())
        rows[name] = {"compute_ms": rec["compute_s"] * 1e3,
                      "memory_ms": rec["memory_s"] * 1e3,
                      "bound_ms": bound_step_time(rec) * 1e3,
                      "bottleneck": rec["bottleneck"],
                      "unfused_memory_ms": rec["unfused_memory_s"] * 1e3,
                      "dot_flops": rec["flops_per_chip"],
                      "f32_dot_share": rec["f32_dot_share"],
                      "bytes": rec["bytes_per_chip"],
                      "unfused_bytes": rec["unfused_bytes_per_chip"],
                      "measured_ms": measured.get(name),
                      "hand_bound_ms": HAND_BOUND_MS.get(name),
                      "count_s": time.perf_counter() - t0}
        log({"phase": "roofline", "path": name, **rows[name]})
    return rows


def start_dryrun() -> list:
    """Start ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_COMBOS`` on the 256-rank fake mesh, each in its own process,
    all at once (CPU work: they run beside the roofline phase's
    counting). Returns ((arch, shape), process, output file) triples."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    started = []
    for arch, shape in DRYRUN_COMBOS:
        out = ROOT / "build" / f"dryrun_{arch}_{shape}.jsonl"
        out.parent.mkdir(exist_ok=True)
        out.unlink(missing_ok=True)
        started.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--json", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT), out))
    return started


def dryrun_phase(started: list) -> dict:
    """Wait for ``start_dryrun``'s processes: each exits 0, prints
    ``OK`` and writes its record; a combo of ``JAX_DOT_FLOPS`` counts at
    most ``DRYRUN_FLOPS_MARGIN`` times JAX's dot FLOPs a chip, and one
    of ``JAX_TEMP_BYTES`` holds at most ``DRYRUN_TEMP_MARGIN`` times
    JAX's temporaries a chip (each combo's temp bytes logged)."""
    try:
        for combo, p, _ in started:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0 and "OK" in stdout, \
                (combo, stdout[-2000:], stderr[-2000:])
    finally:
        for _, p, _ in started:
            p.kill()
    out = {}
    for combo, _, path in started:
        rec = json.loads(path.read_text().splitlines()[-1])
        assert rec["status"] == "ok", rec
        want = JAX_DOT_FLOPS.get(combo)
        if want is not None:
            got = rec["roofline"]["flops_per_chip"]
            rec["jax_dot_flops"], rec["port_over_jax"] = want, got / want
            assert got <= DRYRUN_FLOPS_MARGIN * want, (combo, got, want)
        want = JAX_TEMP_BYTES.get(combo)
        if want is not None:
            got = rec["memory"]["temp_size_in_bytes"]
            rec["jax_temp_bytes"], rec["temp_over_jax"] = want, got / want
            assert got <= DRYRUN_TEMP_MARGIN * want, (combo, got, want)
        log({"phase": "dryrun", "temp_bytes":
             rec["memory"]["temp_size_in_bytes"], **rec})
        out[" ".join(combo)] = rec
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
    phases["kernel_ops"] = kernel_ops_phase(dev)
    lap("kernel_ops")
    phases["model"] = model_phase(dev)
    phases["decode_model"] = decode_model_phase(dev)
    lap("model")
    serve, stack = serve_phase(dev)
    phases["serve"] = serve
    phases["generate"] = gen = generate_phase(dev, stack)
    lap("yi-6b")
    # the fleet runtime on the same full-width yi-6b
    phases["serve_tiers"] = serve_tiers_phase(dev, stack)
    lap("serve_tiers")
    phases["serve_cluster"] = serve_cluster_phase(dev, stack)
    lap("serve_cluster")
    phases["serve_chaos"] = serve_chaos_phase(dev, stack)
    lap("serve_chaos")
    phases["serve_early_emit"] = serve_early_emit_phase(dev, stack)
    lap("serve_early_emit")
    phases["serve_data_parallel"] = serve_data_parallel_phase(dev, stack)
    lap("serve_data_parallel")
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
    phases["train_mesh"] = train_mesh_phase(dev, phases["train"])
    lap("train_mesh")
    phases["examples"] = examples_phase(dev)
    lap("examples")
    measured = {
        "yi-6b serve window prefill":
            serve["main"]["remote_prefill_ms_per_window"],
        "yi-6b decode step": gen["decode_step_ms_median"],
        "yi-6b train step": phases["train"]["step_s_median"] * 1e3,
        "rwkv6-1.6b decode step": rwkv_gen["decode_step_ms_median"],
        "h2o-danube-1.8b decode step":
            phases["generate_h2o-danube-1.8b"]["decode_step_ms_median"]}
    dryruns = start_dryrun()
    phases["roofline"] = roofline_phase(measured)
    lap("roofline")
    phases["dryrun"] = dryrun_phase(dryruns)
    lap("dryrun")
    from repro_torch.launch.mesh import destroy
    destroy()
    log({"phase": "seconds", **seconds})
    line = kernels_line(kern, serve, gen, rwkv_gen, sup)
    RESULTS["kernels"] = line["kernels"]
    # profiler captures by the attempts each took (an empty trace is
    # taken again)
    from repro_torch.kernels.profiling import CAPTURES
    RESULTS["profiler_captures"] = dict(sorted(CAPTURES.items()))
    log({"phase": "profiler_captures", **RESULTS["profiler_captures"]})
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
