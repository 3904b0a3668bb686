"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device every test skips (the fixture
decides at run time). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: pred and idx exact (inputs are checked for gaps first);
conf rtol 1e-4 / atol 1e-6 (fp32 online softmax summed in another
order; the head gate's tensor-core form against float64 within a tenth
of that limit at the yi-6b head); the select exact;
attention f32 atol 1e-4 against the plain version run in f32 on the same
inputs; bf16 prefill atol 2e-2 (one bf16 rounding of outputs of order 1,
and the tensor-core kernel's rounding of P to bf16 before P V),
bf16 decode |err| <= 2^-8 |want| + 1e-3 (one bf16 rounding, at most 2^-8
relative, and the fp32 sums: a limit that shrinks with the small outputs
of a softmax over a long cache); maxconf's prediction exact (planted ties resolve to
the first index), max_softmax and pcs atol 1e-5, entropy atol
2e-6 * max|logit| + 1e-5 (the kernel's ``m1 + log s - t/s`` is a
difference of terms as large as the top logit); the RWKV6 scan's y and
state 2e-5 * max|want| + 1e-5 against the plain version in f32 on the
same inputs (fp32 sums of M products in another order, and FMA
contraction in the state update, drifting by a few ulp per step); the
MDSA distance rtol 1e-4 / atol 1e-4 (fp32 quadratic forms of up to 4096^2
products summed in another order), and against float64 within a
hundredth of that limit at [256, 4096] (the kernel adds each depth step's
tensor-core sums on the CUDA cores; summed on the tensor cores over all
of D, the error was 6.4% of it on an H100).
The train path (plain functions, no kernel) on the card against the CPU
on reduced models in fp32: loss rtol 1e-5, every gradient leaf within
``tol * max|g| + 1e-7`` (1e-4 for yi-6b; 2e-3 for rwkv6, whose leaves
that feed r and k amplify the matmuls' fp32 rounding about 1e4-fold, as
``tests/test_torch_train.py`` measures against JAX).
TF32 is switched off so the plain versions compute in full fp32, as the
kernels do.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.confidence_gate import kernel as gate_kernel  # noqa: E402
from repro_torch.kernels.confidence_gate.ops import confidence_gate, select  # noqa: E402
from repro_torch.kernels.confidence_gate.ref import confidence_gate_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.confidence_gate.ref import select_ref  # noqa: E402
from repro_torch.kernels.fused_head_gate import \
    kernel as fused_head_kernel  # noqa: E402
from repro_torch.kernels.fused_head_gate.ops import fused_head_gate  # noqa: E402
from repro_torch.kernels.fused_head_gate.ref import (  # noqa: E402
    fused_head_gate_ref, head_logits)
from repro_torch.kernels.maxconf import kernel as maxconf_kernel  # noqa: E402
from repro_torch.kernels.maxconf.ops import maxconf  # noqa: E402
from repro_torch.kernels.maxconf.ref import maxconf_ref  # noqa: E402
from repro_torch.kernels.mdsa.kernel import plan as mdsa_plan  # noqa: E402
from repro_torch.kernels.mdsa.ops import mdsa_distance  # noqa: E402
from repro_torch.kernels.mdsa.ref import mdsa_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.kernel import CHUNK  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402

pytestmark = pytest.mark.cuda
SUPERVISORS = ("max_softmax", "pcs", "neg_entropy", "gini")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def gapped(conf, n_valid, gap=1e-3):
    c = np.sort(conf[:n_valid].double().cpu().numpy())
    i = int(np.argmax(np.diff(c)))
    assert np.diff(c).min() > gap, "inputs: confidences too close"
    return float((c[i] + c[i + 1]) / 2)


def on_card(x: np.ndarray, dev, dtype, offset: int = 0):
    """x as a [B, C] tensor on the card; with ``offset`` > 0 it starts
    ``offset`` elements into a buffer, so its rows are not 16-byte
    aligned."""
    t = torch.from_numpy(x).to(dev).to(dtype)
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


def check_gate_out(got, want):
    torch.cuda.synchronize()
    assert torch.allclose(got["conf"], want["conf"], rtol=1e-4, atol=1e-6)
    assert torch.equal(got["pred"], want["pred"])
    assert torch.equal(got["idx"], want["idx"])


# (b, c, dtype, offset): narrow rows (C < 4096, a warp each) and wide rows
# (a cluster each), C odd or below one vector, rows not 16-byte aligned
STATS_SHAPES = [(8, 8, torch.float32, 0),
                (13, 3000, torch.float32, 0),
                (32, 64000, torch.bfloat16, 0),
                (5, 3, torch.float32, 1),           # C below one vector
                (5, 3, torch.bfloat16, 0),
                (7, 1001, torch.bfloat16, 0),       # odd C: rows alternate
                (5, 4099, torch.float32, 3),        # wide, odd, offset
                (6, 9001, torch.bfloat16, 5),
                (13, 4096, torch.float32, 2),
                (4, 152064, torch.float32, 1)]      # 8 ranks a row


@pytest.mark.parametrize("sup", SUPERVISORS)
@pytest.mark.parametrize("b,c,dtype,offset", STATS_SHAPES)
def test_gate_kernel_matches_plain(dev, sup, b, c, dtype, offset):
    rng = np.random.default_rng(b + c)
    x = rng.standard_normal((b, c)).astype(np.float32)
    # one planted maximum per row, heights spread so confidences differ
    # by more than the kernel's rounding at any vocabulary size
    base, step = (8.0, 0.25) if c > 10_000 else (4.0, 0.7)
    x[np.arange(b), rng.integers(0, c, b)] = base + step * rng.permutation(b)
    logits = on_card(x, dev, dtype, offset)
    n_valid = b - 2
    t = gapped(confidence_gate_ref(logits, supervisor=sup)["conf"], n_valid,
               gap=1e-5)
    before = launch_counts()
    got = confidence_gate(logits, t, n_valid, supervisor=sup)
    check_gate_out(got, confidence_gate_ref(logits, t, n_valid,
                                            supervisor=sup))
    after = launch_counts()
    assert after["gate_score"] == before["gate_score"] + 1
    assert after["gate_select"] == before["gate_select"] + 1


def head_inputs(dev, b, d, c, wdt, hdt=torch.float32, offset=0):
    """h [B, D] (hdt), w [D, C] (wdt; with ``offset`` > 0 starting that
    many elements into a buffer, rows not 16-byte aligned), bias [C]."""
    rng = np.random.default_rng(b * d + c)
    h = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    w = (rng.standard_normal((d, c)) * 3 / np.sqrt(d)).astype(np.float32)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    return h.to(dev).to(hdt), on_card(w, dev, wdt, offset), bias.to(dev)


# (b, d, c, w dtype): the serve path's narrow form, the tensor-core form
# with ragged C (a block and a cluster partly filled) and D not a
# multiple of the MMA's 16 (or of the ring's 32), more than 32 rows (two
# row groups), the FMA tile (f32 w; bf16 w with C % 8 != 0)
@pytest.mark.parametrize("b,d,c,wdt", [(8, 32, 8, torch.float32),
                                       (40, 96, 700, torch.bfloat16),
                                       (32, 4096, 8000, torch.bfloat16),
                                       (32, 4100, 8008, torch.bfloat16),
                                       (33, 100, 4104, torch.bfloat16),
                                       (70, 1000, 5000, torch.float32),
                                       (5, 300, 4099, torch.bfloat16),
                                       (32, 24, 1032, torch.bfloat16)])
def test_fused_head_kernel_matches_plain(dev, b, d, c, wdt):
    h, w, bias = head_inputs(dev, b, d, c, wdt)
    t = gapped(fused_head_gate_ref(h, w, bias)["conf"], b, gap=1e-6)
    check_gate_out(fused_head_gate(h, w, bias, t, b - 1),
                   fused_head_gate_ref(h, w, bias, t, b - 1))


@pytest.mark.parametrize("b,d,c", [(32, 4096, 8000), (33, 100, 4104),
                                   (8, 32, 8)])
def test_fused_head_kernel_bf16_hidden(dev, b, d, c):
    """A bf16 hidden state: one bf16 piece on the tensor cores."""
    h, w, bias = head_inputs(dev, b, d, c, torch.bfloat16, torch.bfloat16)
    t = gapped(fused_head_gate_ref(h, w, bias)["conf"], b, gap=1e-6)
    check_gate_out(fused_head_gate(h, w, bias, t, b - 1),
                   fused_head_gate_ref(h, w, bias, t, b - 1))


@pytest.mark.parametrize("sup", SUPERVISORS)
def test_fused_head_kernel_every_supervisor(dev, sup):
    h, w, bias = head_inputs(dev, 32, 512, 4096, torch.bfloat16)
    t = gapped(fused_head_gate_ref(h, w, bias, supervisor=sup)["conf"], 32,
               gap=1e-6)
    check_gate_out(fused_head_gate(h, w, bias, t, 31, supervisor=sup),
                   fused_head_gate_ref(h, w, bias, t, 31, supervisor=sup))


def test_fused_head_kernel_unaligned_w_takes_the_fma_tile(dev):
    """bf16 w whose rows start off 16 bytes cannot feed the tensor-core
    form's 16-byte copies: the plan takes the FMA tile."""
    h, w, bias = head_inputs(dev, 16, 512, 4096, torch.bfloat16, offset=1)
    assert fused_head_kernel.head_plan(16, 512, 4096, h.dtype, w.dtype,
                                      False).form \
        == "fma"
    t = gapped(fused_head_gate_ref(h, w, bias)["conf"], 16, gap=1e-6)
    check_gate_out(fused_head_gate(h, w, bias, t, 15),
                   fused_head_gate_ref(h, w, bias, t, 15))


@pytest.mark.parametrize("b,d,c,wdt", [(32, 32, 8, torch.float32),
                                       (32, 4096, 8000, torch.bfloat16),
                                       (70, 1000, 5000, torch.float32)])
def test_fused_head_gate_runs_one_kernel_and_allocates_scratch_once(
        dev, b, d, c, wdt):
    """Each call runs one device kernel (narrow, tensor-core or FMA form)
    and makes one allocation, its [2, B] output; the wide forms' merge
    scratch is made on the first call only, and the kernel leaves its
    tickets zero."""
    from torch.profiler import ProfilerActivity, profile
    h, w, bias = head_inputs(dev, b, d, c, wdt)
    call = lambda: fused_head_kernel.fused_head_gate(h, w, bias,  # noqa: E731
                                                     "max_softmax")
    first = call()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    again = call()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] \
        == stats + 1
    for a, b_ in zip(first, again):         # deterministic merge order
        assert torch.equal(a, b_)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.count]
    assert round(sum(e.count for e in kern) / 10) == 1
    assert all("head_gate_" in e.key for e in kern)
    plan = fused_head_kernel.head_plan(b, d, c, h.dtype, wdt)
    if plan.form != "narrow":
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = fused_head_kernel._SCRATCH[
            (h.device.index, stream,
             fused_head_kernel._ticket_ints(plan.groups))]
        assert int(scratch[:plan.groups].abs().sum()) == 0


def test_fused_head_kernel_plans_with_other_ticket_regions_on_one_stream(
        dev):
    """One row group ([32, 4096] x [4096, 64000]: tickets in int32s 0-7,
    partials from 8), then nine (B = 288, C = 1000: tickets 0-15, a
    smaller scratch) on the same stream, and again: each plan's tickets
    start zero, so every row is merged once and right."""
    big = head_inputs(dev, 32, 4096, 64000, torch.bfloat16)
    small = head_inputs(dev, 288, 256, 1000, torch.bfloat16)
    for h, w, bias in (big, small, big, small):
        conf, pred = fused_head_kernel.fused_head_gate(h, w, bias,
                                                       "max_softmax")
        want = fused_head_gate_ref(h, w, bias)
        torch.cuda.synchronize()
        assert torch.allclose(conf, want["conf"], rtol=1e-4, atol=1e-6)
        assert torch.equal(pred, want["pred"])


def test_fused_head_kernel_error_against_float64(dev):
    """At the yi-6b head ([32, 4096] x [4096, 64000], w bf16, hidden f32)
    conf's error against a float64 computation on the same inputs stays
    within a tenth of rtol 1e-4 / atol 1e-6 (three exact bf16 pieces on
    the tensor cores, each 16-deep step summed on the CUDA cores), as
    close as the fp32 plain version's."""
    from repro_torch.core.supervisors import max_softmax
    h, w, bias = head_inputs(dev, 32, 4096, 64000, torch.bfloat16)
    conf, pred = fused_head_kernel.fused_head_gate(h, w, bias, "max_softmax")
    logits64 = h.double() @ w.double() + bias.double()
    want = torch.softmax(logits64, -1).max(-1).values
    used = ((conf.double() - want).abs() / (1e-4 * want + 1e-6)).max()
    plain = ((max_softmax(head_logits(h, w, bias)).double() - want).abs()
             / (1e-4 * want + 1e-6)).max()
    assert used <= 0.1, f"{float(used):.4f} of the limit"
    assert used <= 2 * plain + 0.01
    assert torch.equal(pred, logits64.argmax(-1).int())


# (b, k): the warp form (B <= 32) and the sort form, one warp up to the
# largest B; k = 1, k = min(64, B) and k = B
SELECT_SHAPES = [1, 2, 31, 32, 33, 1000, 4096, 12288, 16384]


def planted_conf(b: int, seed: int) -> np.ndarray:
    """Confidences with ties, -0.0 beside +0.0, +-inf and NaN planted."""
    rng = np.random.default_rng(seed)
    c = rng.random(b).astype(np.float32)
    if b >= 16:
        rows = rng.permutation(b)
        c[rows[:max(2, b // 16)]] = c[rows[-1]]
        for n, v in enumerate((0.0, -0.0, np.inf, -np.inf, np.nan)):
            c[rows[b // 16 + 2 * n:b // 16 + 2 * n + 2]] = v
    return c


@pytest.mark.parametrize("b", SELECT_SHAPES)
def test_select_kernel_matches_plain(dev, b):
    """The rank select, exactly against select_ref: thresholds at +inf,
    in the middle, at 0.0 (the zeros are not below it) and NaN (nothing
    taken), padding rows past n_valid, k below and at B."""
    conf = torch.from_numpy(planted_conf(b, b)).to(dev)
    for k in sorted({1, min(64, b), b}):
        for t in (float("inf"), 0.5, 0.0, float("nan"),
                  float(conf[b // 2])):
            for n in sorted({b, b - b // 10, 0}):
                tt = torch.tensor(t, dtype=torch.float32, device=dev)
                nn = torch.tensor(n, dtype=torch.int32, device=dev)
                got = gate_kernel.gate_select(conf, tt, nn, k)
                want = select_ref(conf, tt, nn, k)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, t, n)


def test_select_kernel_one_launch_and_limits(dev):
    conf = torch.zeros(gate_kernel.MAX_SELECT_ROWS + 1, device=dev)
    tt = torch.tensor(0.5, device=dev)
    nn = torch.tensor(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="B <="):
        gate_kernel.gate_select(conf, tt, nn, 4)
    with pytest.raises(ValueError, match="1 <= k"):
        gate_kernel.gate_select(conf[:8], tt, nn, 9)
    from torch.profiler import ProfilerActivity, profile
    for b in (32, 4096):
        c = torch.from_numpy(planted_conf(b, 1)).to(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                gate_kernel.gate_select(c, tt, nn, b)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.count]
        assert round(sum(e.count for e in kern) / 10) == 1
        assert all("gate_select_" in e.key for e in kern)


@pytest.mark.parametrize("b,t,h,kh,hd,causal,window,dtype", [
    (2, 48, 32, 4, 128, True, 0, torch.bfloat16),
    (1, 130, 8, 2, 64, True, 0, torch.float32),
    (2, 77, 4, 4, 128, True, 16, torch.float32),
    (1, 1, 32, 4, 128, True, 0, torch.bfloat16),     # T = 1: 8 of 64 rows
    (1, 1, 8, 2, 128, True, 0, torch.float32),       # T = 1
    (2, 77, 12, 4, 128, True, 0, torch.bfloat16),    # T*G = 231, S = 77
    (2, 300, 32, 4, 128, True, 64, torch.bfloat16),  # sliding window
    (1, 200, 8, 2, 128, False, 0, torch.bfloat16),   # non-causal
    (1, 100, 4, 4, 64, False, 24, torch.bfloat16),   # non-causal window
    (2, 130, 8, 2, 64, True, 0, torch.bfloat16),     # hd 64
    (1, 1000, 32, 4, 128, True, 0, torch.bfloat16),  # 16 key tiles, ragged
    (2, 1100, 32, 4, 128, True, 0, torch.bfloat16),  # T*G % 64 = 32
    (4, 600, 32, 4, 128, False, 100, torch.bfloat16),
    (8, 300, 16, 2, 64, True, 0, torch.bfloat16),
    # hd 80 (h2o-danube-1.8b: 32 heads over 8), staged at 128
    (2, 300, 32, 8, 80, True, 0, torch.bfloat16),
    (1, 700, 32, 8, 80, True, 256, torch.bfloat16),  # window, ragged
    (2, 77, 32, 8, 80, True, 0, torch.float32),
    (1, 130, 8, 2, 80, False, 24, torch.float32),
    # a group of 7 (qwen2-7b: 28 heads over 4): T*G not a multiple of 64
    (2, 200, 28, 4, 128, True, 0, torch.bfloat16),
    (1, 130, 28, 4, 128, True, 0, torch.float32),
    (1, 100, 14, 2, 80, False, 24, torch.bfloat16),  # G = 7 at hd 80
    # hd 112 (zamba2-7b's shared block: 32 heads, MHA), staged at 128
    (8, 48, 32, 32, 112, True, 0, torch.bfloat16),   # a serve window
    (8, 512, 32, 32, 112, True, 0, torch.bfloat16),  # the generate prefill
    (2, 77, 32, 32, 112, True, 0, torch.float32),
    (1, 300, 16, 4, 112, True, 64, torch.bfloat16),  # group of 4, window
    (1, 130, 8, 2, 112, False, 0, torch.float32),    # group of 4
])
def test_flash_kernel_matches_plain(dev, b, t, h, kh, hd, causal, window,
                                    dtype):
    rng = np.random.default_rng(t + h)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, t, n, hd)).astype(np.float32)).to(dev)
    q, k, v = mk(h).to(dtype), mk(kh).to(dtype), mk(kh).to(dtype)
    before = launch_counts()["flash_attention"]
    got = attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_nothing_past_t_or_s(dev, causal, dtype):
    """q, k and v are each the head of a buffer whose tail is NaN: a read
    past T (the ragged last row tile, T*G = 231 rows) or past S (the
    ragged last key tile, S = 77) makes the output non-finite."""
    b, t, h, kh, hd = 1, 77, 12, 4, 128
    rng = np.random.default_rng(3)

    def mk(n):
        size = b * t * n * hd
        buf = torch.full((size + 8192,), float("nan"), dtype=dtype,
                         device=dev)
        buf[:size] = torch.from_numpy(
            rng.standard_normal(size).astype(np.float32)).to(dev).to(dtype)
        return buf[:size].view(b, t, n, hd)

    q, k, v = mk(h), mk(kh), mk(kh)
    got = attention(q, k, v, causal=causal)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("b,v,dtype,offset", [
    (8, 64000, torch.float32, 0),
    (32, 152064, torch.float32, 0),
    (5, 3001, torch.bfloat16, 0),
    (1, 7, torch.float32, 0),
    (8, 64001, torch.float32, 0),       # odd V, wide: rows alternate
    (8, 64001, torch.bfloat16, 0),
    (8, 64000, torch.float32, 1),       # a storage offset: no row aligned
    (4, 30001, torch.bfloat16, 3),
    (6, 3, torch.float32, 2),           # V below one vector
    (3, 5, torch.bfloat16, 0),
    (300, 4097, torch.float32, 0),      # many wide rows
    (300, 77, torch.bfloat16, 1)])      # many narrow rows
def test_maxconf_kernel_matches_plain(dev, b, v, dtype, offset):
    rng = np.random.default_rng(b + v)
    x = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    top = rng.integers(0, v, b)
    x[np.arange(b), top] = 20.0 + rng.permutation(b)   # above any normal
    for r in range(0, b, 2):            # a tie at a later column
        if top[r] + 1 < v:
            x[r, rng.integers(top[r] + 1, v)] = x[r, top[r]]
    logits = on_card(x, dev, dtype, offset)
    before = launch_counts()["maxconf"]
    got = maxconf(logits)
    want = maxconf_ref(logits)
    torch.cuda.synchronize()
    assert launch_counts()["maxconf"] == before + 1
    assert torch.equal(got["prediction"], want["prediction"])
    assert got["prediction"].cpu().tolist() == top.tolist()
    ent_tol = 2e-6 * float(logits.float().abs().max()) + 1e-5
    for key, tol in (("max_softmax", 1e-5), ("pcs", 1e-5),
                     ("entropy", ent_tol)):
        assert got[key].dtype == torch.float32
        assert float((got[key] - want[key]).abs().max()) <= tol, key


@pytest.mark.parametrize("b,c", [(32, 8), (8, 64000), (32, 152064)])
def test_maxconf_and_gate_score_run_one_kernel_and_allocate_once(dev, b, c):
    """Each wrapper call runs one device kernel (the statistics pass, its
    epilogue included) and makes one allocation, its outputs: no
    scratch and no second pass."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (b, c)).astype(np.float32)).to(dev)
    calls = (lambda: maxconf_kernel.maxconf(x),
             lambda: gate_kernel.gate_score(x, "gini"))
    for call in calls:
        call()
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        call()
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] \
            == stats + 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.count]
        # the profiler drops an event now and then: launches are rounded
        assert round(sum(e.count for e in kern) / 10) == 1
        assert all("vocab_stats_kernel" in e.key for e in kern)


@pytest.mark.parametrize("b,s,h,kh,hd,lens,dtype", [
    (8, 544, 32, 4, 128, [543] * 8, torch.bfloat16),
    (8, 544, 32, 4, 128, [543] * 8, torch.float32),
    (8, 544, 32, 4, 128, [1, 544, 100, 272, 400, 7, 543, 33], torch.bfloat16),
    (8, 64, 32, 4, 128, [64] * 8, torch.bfloat16),
    (8, 16384, 32, 4, 128, [16384] * 8, torch.bfloat16),
    (3, 77, 8, 2, 64, [1, 77, 40], torch.float32),
    (2, 100, 16, 1, 64, [100, 31], torch.bfloat16),
    (2, 96, 4, 4, 64, [96, 5], torch.float32),
    # kv_len on tile and split boundaries (chunk 64 at this shape)
    (8, 544, 32, 4, 128, [32, 64, 128, 96, 544, 65, 63, 33], torch.bfloat16),
    # kv_len = 1 inside a split of 11 tiles
    (2, 16384, 32, 4, 128, [1, 5000], torch.bfloat16),
    (2, 1000, 32, 4, 128, [1000, 999], torch.bfloat16),  # S % 32 != 0
    (2, 100, 12, 4, 64, [100, 50], torch.bfloat16),      # G = 3, padded
    (2, 300, 16, 1, 128, [300, 129], torch.float32),     # 138 KB shared
    # hd 80 (h2o-danube-1.8b), rows staged at 128
    (8, 544, 32, 8, 80, [543] * 8, torch.bfloat16),
    (8, 544, 32, 8, 80, [1, 544, 100, 272, 400, 7, 543, 33], torch.float32),
    (1, 4096, 32, 8, 80, [4096], torch.bfloat16),        # the full ring
    (3, 77, 14, 2, 80, [1, 77, 40], torch.bfloat16),     # G = 7 at hd 80
    # a group of 7 (qwen2-7b), padded to 8
    (8, 544, 28, 4, 128, [543] * 8, torch.bfloat16),
    (2, 300, 28, 4, 128, [300, 129], torch.float32),
    # hd 112 (zamba2-7b's shared block, MHA: a group of 1 padded to 8)
    (8, 544, 32, 32, 112, [543] * 8, torch.bfloat16),
    (8, 544, 32, 32, 112, [1, 544, 100, 272, 400, 7, 543, 33],
     torch.float32),
    (2, 300, 16, 4, 112, [300, 129], torch.bfloat16),    # group of 4
])
def test_decode_kernel_matches_plain(dev, b, s, h, kh, hd, lens, dtype):
    rng = np.random.default_rng(s + h)
    q = torch.from_numpy(rng.standard_normal((b, h, hd), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kh, hd), np.float32))
            for _ in range(2))
    q, k, v = (t.to(dev).to(dtype) for t in (q, k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = launch_counts()["decode_attention"]
    got = decode_attn(q, k, v, kv_len)
    want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    rtol, atol = (2.0 ** -8, 1e-3) if dtype == torch.bfloat16 else (0.0, 1e-4)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(((got.float() - want).abs()
                 <= rtol * want.abs() + atol).all())


def test_decode_kernel_reads_no_slot_past_kv_len(dev):
    """NaN planted past each row's kv_len never reaches the output."""
    b, s, h, kh, hd = 2, 200, 8, 2, 128
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, hd), np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kh, hd), np.float32))
            .to(dev) for _ in range(2))
    lens = [70, 129]
    for r, n in enumerate(lens):
        k[r, n:] = float("nan")
        v[r, n:] = float("nan")
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attn(q, k, v, kv_len)
    want = torch.stack([decode_attention_ref(q[r:r + 1], k[r:r + 1, :n],
                                             v[r:r + 1, :n], kv_len[r:r + 1])
                        for r, n in enumerate(lens)])[:, 0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4


def padded_rows_read_nothing_past(dev, dtype, hd: int, groups) -> None:
    """Flash's q, k and v and the decode caches at head dim ``hd`` (rows
    staged wider) are each the head of a buffer whose tail is NaN, and
    the decode caches hold NaN past each row's kv_len: a read of a
    padding column past a row's end, past T or S, or past kv_len makes
    the output non-finite. ``groups``: flash's and decode's (heads, KV
    heads)."""
    rng = np.random.default_rng(hd)

    def nan_tailed(*shape):
        size = int(np.prod(shape))
        buf = torch.full((size + 8192,), float("nan"), dtype=dtype,
                         device=dev)
        buf[:size] = torch.from_numpy(
            rng.standard_normal(size).astype(np.float32)).to(dev).to(dtype)
        return buf[:size].view(*shape)

    (h, kh), (hd_h, hd_kh) = groups
    b, t = 1, 77
    q, k, v = nan_tailed(b, t, h, hd), nan_tailed(b, t, kh, hd), \
        nan_tailed(b, t, kh, hd)
    got = attention(q, k, v, causal=True)
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - want).abs().max()) <= atol

    b, s = 2, 200
    qd = nan_tailed(b, hd_h, hd)
    kc, vc = nan_tailed(b, s, hd_kh, hd), nan_tailed(b, s, hd_kh, hd)
    lens = [70, 129]
    for r, n in enumerate(lens):
        kc[r, n:] = float("nan")
        vc[r, n:] = float("nan")
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attn(qd, kc, vc, kv_len)
    want = torch.stack([decode_attention_ref(
        qd[r:r + 1].float(), kc[r:r + 1, :n].float(), vc[r:r + 1, :n].float(),
        kv_len[r:r + 1]) for r, n in enumerate(lens)])[:, 0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rtol, atol = (2.0 ** -8, 1e-3) if dtype == torch.bfloat16 else (0.0, 1e-4)
    assert bool(((got.float() - want).abs()
                 <= rtol * want.abs() + atol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hd80_kernels_read_nothing_past_their_rows(dev, dtype):
    """At hd 80 each row is 160 bytes, staged in rows of 128 columns."""
    padded_rows_read_nothing_past(dev, dtype, 80, ((14, 2), (16, 2)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hd112_kernels_read_nothing_past_their_rows(dev, dtype):
    """At hd 112 each row is 224 bytes, staged in rows of 128 columns;
    MHA (a group of 1) as zamba2-7b's shared block runs it."""
    padded_rows_read_nothing_past(dev, dtype, 112, ((8, 8), (8, 8)))


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        confidence_gate(torch.zeros(4, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        confidence_gate(torch.zeros(8, 4, device=dev).t())
    q = torch.zeros(1, 8, 4, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        attention(q, q, q)
    # the bf16 kernel's 16-byte copies need aligned rows
    off = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16,
                      device=dev)[1:].view(1, 8, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        attention(off, off, off)
    # a callable supervisor has no kernel yet: never the plain version
    margin = lambda lg: lg.max(-1).values - lg.mean(-1)  # noqa: E731
    with pytest.raises(ValueError, match="softmax family"):
        confidence_gate(torch.zeros(4, 8, device=dev), supervisor=margin)
    # maxconf: float64, a 3-D input, a non-contiguous view
    with pytest.raises(TypeError):
        maxconf(torch.zeros(4, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="dims"):
        maxconf(torch.zeros(2, 4, 8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        maxconf(torch.zeros(8, 4, device=dev).t())
    # decode attention: dtype, head dim, group size, shapes, kv_len dtype
    q = torch.zeros(2, 8, 128, device=dev)
    kc = torch.zeros(2, 16, 2, 128, device=dev)
    lens = torch.full((2,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        decode_attn(q.double(), kc.double(), kc.double(), lens)
    with pytest.raises(TypeError, match="share a dtype"):
        decode_attn(q.bfloat16(), kc, kc, lens)
    with pytest.raises(ValueError, match="head dim"):
        decode_attn(q[..., :32].contiguous(), kc[..., :32].contiguous(),
                    kc[..., :32].contiguous(), lens)
    with pytest.raises(ValueError, match="query heads per KV head"):
        decode_attn(torch.zeros(2, 32, 128, device=dev), kc[:, :, :1]
                    .contiguous(), kc[:, :, :1].contiguous(), lens)
    with pytest.raises(ValueError, match="shapes"):
        decode_attn(q, kc, kc[:, :8].contiguous(), lens)
    with pytest.raises(ValueError, match="shapes"):
        decode_attn(q, kc, kc, lens[:1])
    with pytest.raises(TypeError):
        decode_attn(q, kc, kc, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn(q, kc.transpose(1, 2), kc.transpose(1, 2), lens)


# ------------------------------------------------------------ RWKV6 scan

def scan_inputs(dev, b, t, h, m, dtype, seed, tail=0):
    """r, k, v (dtype) and w, u, s0 (f32) on the card, w in (0, 1) spread
    from fast to slow decay. With ``tail`` > 0 each tensor is the head of
    a buffer whose next ``tail`` elements are NaN."""
    rng = np.random.default_rng(seed)

    def mk(shape, values, dt):
        n = int(np.prod(shape))
        buf = torch.full((n + tail,), float("nan"), dtype=dt, device=dev)
        buf[:n] = torch.from_numpy(values.reshape(-1)).to(dev).to(dt)
        return buf[:n].view(shape)

    shape = (b, t, h, m)
    r, k, v = (mk(shape, 0.5 * rng.standard_normal(shape), dtype)
               for _ in range(3))
    w = mk(shape, np.exp(-np.exp(rng.standard_normal(shape) - 3.0)),
           torch.float32)
    u = mk((h, m), 0.5 * rng.standard_normal((h, m)), torch.float32)
    s0 = mk((b, h, m, m), 0.5 * rng.standard_normal((b, h, m, m)),
            torch.float32)
    return r, k, v, w, u, s0


def scan_close(got, want) -> None:
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == x.shape
        tol = 2e-5 * float(x.abs().max()) + 1e-5
        assert float((g - x).abs().max()) <= tol


@pytest.mark.parametrize("b,t,h,m,dtype", [
    (8, 512, 32, 64, torch.bfloat16),     # the generate prefill
    (8, 48, 32, 64, torch.bfloat16),      # a serve window
    (8, 1, 32, 64, torch.bfloat16),       # a decode step
    (2, 128, 2, 32, torch.float32),
    (3, 100, 4, 64, torch.float32),
    (2, 70, 3, 16, torch.bfloat16),
])
def test_rwkv6_scan_kernel_matches_plain(dev, b, t, h, m, dtype):
    r, k, v, w, u, s0 = scan_inputs(dev, b, t, h, m, dtype, seed=t + m)
    s_keep = s0.clone()
    before = launch_counts()["rwkv6_scan"]
    got = rwkv6_scan(r, k, v, w, u, s0)
    want = rwkv6_scan_ref(r.float(), k.float(), v.float(), w, u, s0)
    assert launch_counts()["rwkv6_scan"] == before + 1
    scan_close(got, want)
    assert torch.equal(s0, s_keep)          # s0 is not written


@pytest.mark.parametrize("t", [1, 33])
def test_rwkv6_scan_kernel_updates_aliased_state(dev, t):
    """Decode passes the layer's state as both s0 and s_out."""
    r, k, v, w, u, s0 = scan_inputs(dev, 8, t, 32, 64, torch.bfloat16,
                                    seed=40 + t)
    want = rwkv6_scan_ref(r, k, v, w, u, s0.clone())
    y, s_t = rwkv6_scan(r, k, v, w, u, s0, s0)
    assert s_t.data_ptr() == s0.data_ptr()
    scan_close((y, s0), want)


def test_rwkv6_scan_kernel_state_carry(dev):
    r, k, v, w, u, s0 = scan_inputs(dev, 4, 96, 8, 64, torch.float32,
                                    seed=50)
    y_full, s_full = rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    parts = [rwkv6_scan(r[:, a:e].contiguous(), k[:, a:e].contiguous(),
                        v[:, a:e].contiguous(), w[:, a:e].contiguous(), u,
                        state, state)[0]
             for a, e in ((0, 40), (40, 41), (41, 96))]
    scan_close((torch.cat(parts, 1), state), (y_full, s_full))


def test_rwkv6_scan_kernel_reads_nothing_past_its_inputs(dev):
    """Every input is followed by NaN: a read past any tensor's end (the
    ragged last chunk of T = 70, M = 16 heads) makes the output
    non-finite."""
    args = scan_inputs(dev, 2, 70, 3, 16, torch.bfloat16, seed=60, tail=4096)
    y, s_t = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_t).all())
    scan_close((y, s_t), rwkv6_scan_ref(*args))


@pytest.mark.parametrize("m,dtype", [
    (16, torch.bfloat16), (32, torch.bfloat16),
    (16, torch.float32), (32, torch.float32)])
def test_rwkv6_scan_kernel_small_heads_past_two_chunks(dev, m, dtype):
    """M = 16 and 32 (fewer state rows per thread) over T = 2 chunks + 7,
    the last chunk clipped, with NaN after every input."""
    t = 2 * CHUNK + 7
    args = scan_inputs(dev, 3, t, 5, m, dtype, seed=m + t, tail=4096)
    got = rwkv6_scan(*args)
    scan_close(got, rwkv6_scan_ref(*(a.float() for a in args)))


def test_rwkv6_scan_kernel_is_deterministic(dev):
    """Two calls on the same inputs give the same bits (one writer per
    output element, sums in a fixed order)."""
    args = scan_inputs(dev, 8, 512, 32, 64, torch.bfloat16, seed=90)
    y1, s1 = rwkv6_scan(*args)
    y2, s2 = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_rwkv6_scan_raises_on_inputs_its_copies_cannot_take(dev):
    """The kernel's 16-byte copies need r, k, v and w 16-byte aligned."""
    r, k, v, w, u, s0 = scan_inputs(dev, 2, 4, 2, 64, torch.bfloat16, seed=1)
    buf = torch.empty(r.numel() + 1, dtype=r.dtype, device=dev)
    shifted = buf[1:].view(r.shape)
    shifted.copy_(r)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rwkv6_scan(shifted, k, v, w, u, s0)


# ------------------------------------------------------------------ MDSA

def mdsa_inputs(dev, b, d, seed, tail=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((d, d), np.float32)).to(dev)
    prec = a @ a.T * (0.09 / d) + torch.eye(d, device=dev)

    def with_tail(t):
        n = t.numel()
        buf = torch.full((n + tail,), float("nan"), device=dev)
        buf[:n] = t.reshape(-1)
        return buf[:n].view(t.shape)

    x = torch.from_numpy(rng.standard_normal((b, d), np.float32)).to(dev)
    mean = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    return with_tail(x), with_tail(mean.to(dev)), with_tail(prec)


@pytest.mark.parametrize("b,d", [(8, 64), (128, 128), (100, 200), (1, 32),
                                 (256, 4096), (1024, 64), (70, 1000)])
def test_mdsa_kernel_matches_plain(dev, b, d):
    x, mean, prec = mdsa_inputs(dev, b, d, seed=b + d)
    before = launch_counts()["mdsa"]
    got = mdsa_distance(x, mean, prec)
    want = mdsa_ref(x, mean, prec)
    torch.cuda.synchronize()
    assert launch_counts()["mdsa"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b,)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,d", [(256, 4096), (1024, 64)])
def test_mdsa_kernel_error_against_float64(dev, b, d):
    """The kernel's distance against float64 uses under a hundredth of
    the 1e-4 limit: fp32 accuracy, with no bias from the tensor cores'
    accumulation."""
    x, mean, prec = mdsa_inputs(dev, b, d, seed=b + d)
    got = mdsa_distance(x, mean, prec).double()
    y = x.double() - mean.double()
    want = torch.sqrt(torch.clamp(torch.einsum("bd,de,be->b", y,
                                               prec.double(), y), min=0.0))
    torch.cuda.synchronize()
    assert float(((got - want).abs() / (1e-4 * want.abs() + 1e-4)).max()) \
        < 0.01


def test_mdsa_kernel_reads_nothing_past_its_inputs(dev):
    x, mean, prec = mdsa_inputs(dev, 100, 200, seed=70, tail=8192)
    got = mdsa_distance(x, mean, prec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, mdsa_ref(x, mean, prec), rtol=1e-4, atol=1e-4)


def test_mdsa_kernel_sees_only_the_symmetric_part(dev):
    """P = SPD + an antisymmetric part of the same Frobenius norm: a
    quadratic form sees only P's symmetric part, so the distance is the
    SPD's. Holds the kernel's Y P^T form for a P that is not symmetric."""
    b, d = 256, 1024
    x, mean, spd = mdsa_inputs(dev, b, d, seed=80)
    rng = np.random.default_rng(81)
    c = torch.from_numpy(rng.standard_normal((d, d), np.float32)).to(dev)
    anti = c - c.T
    anti *= torch.linalg.norm(spd) / torch.linalg.norm(anti)
    got = mdsa_distance(x, mean, (spd + anti).contiguous())
    torch.cuda.synchronize()
    assert torch.allclose(got, mdsa_ref(x, mean, spd), rtol=1e-4, atol=1e-4)


def test_mdsa_kernel_is_deterministic(dev):
    """Two calls give the same bits: the depth slices' partial sums are
    added in a fixed order by the second pass, with no atomics."""
    assert mdsa_plan(256, 4096).splits > 1
    x, mean, prec = mdsa_inputs(dev, 256, 4096, seed=82)
    a = mdsa_distance(x, mean, prec)
    b = mdsa_distance(x, mean, prec)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,d", [(33, 61), (1, 7), (130, 2050)])
def test_mdsa_kernel_without_16_byte_rows(dev, b, d):
    """D not a multiple of 4: rows are not 16-byte aligned, so the kernel
    copies 4 bytes at a time; NaN follows every input."""
    x, mean, prec = mdsa_inputs(dev, b, d, seed=b + d, tail=4096)
    got = mdsa_distance(x, mean, prec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, mdsa_ref(x, mean, prec), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,d", [(128, 257), (64, 260)])
def test_mdsa_kernel_just_past_a_depth_slice(dev, b, d):
    """The last depth slice holds 1 (or 4) columns of D."""
    p = mdsa_plan(b, d)
    assert p.splits > 1 and (p.splits - 1) * p.slice_len < d
    assert d - (p.splits - 1) * p.slice_len <= 4
    x, mean, prec = mdsa_inputs(dev, b, d, seed=d, tail=4096)
    got = mdsa_distance(x, mean, prec)
    torch.cuda.synchronize()
    assert torch.allclose(got, mdsa_ref(x, mean, prec), rtol=1e-4, atol=1e-4)


def test_new_wrappers_raise_on_what_kernels_do_not_take(dev):
    r, k, v, w, u, s0 = scan_inputs(dev, 2, 4, 2, 64, torch.float32, seed=0)
    with pytest.raises(TypeError, match="share a dtype"):
        rwkv6_scan(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(TypeError):
        rwkv6_scan(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="head size"):
        big = torch.zeros(2, 4, 1, 128, device=dev)
        rwkv6_scan(big, big, big, big, torch.zeros(1, 128, device=dev),
                   torch.zeros(2, 1, 128, 128, device=dev))
    with pytest.raises(ValueError, match="T >= 1"):
        rwkv6_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    with pytest.raises(ValueError, match="shapes"):
        rwkv6_scan(r, k, v, w, u, s0[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(r.transpose(1, 2), k, v, w, u, s0)
    x, mean, prec = mdsa_inputs(dev, 4, 16, seed=0)
    with pytest.raises(TypeError):
        mdsa_distance(x.double(), mean.double(), prec.double())
    with pytest.raises(ValueError, match="contiguous"):
        mdsa_distance(x, mean, prec.t())
    with pytest.raises(ValueError, match="shapes"):
        mdsa_distance(x, mean[:8].contiguous(), prec)


# ------------------------------------------------------------ train path

def test_kernel_wrappers_refuse_inputs_that_need_a_gradient(dev):
    """A kernel has no backward: with grad mode on, a CUDA input that
    requires grad raises (the kernel's output would cut the graph without
    a word); under no_grad the same call launches."""
    rng = np.random.default_rng(40)

    def grad_input(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).requires_grad_()

    logits, conf = grad_input(4, 8), grad_input(8)
    hidden, w = grad_input(4, 32), grad_input(32, 8)
    q = grad_input(1, 16, 4, 64)
    dq, kc = grad_input(2, 8, 128), grad_input(2, 16, 2, 128)
    lens = torch.full((2,), 16, dtype=torch.int32, device=dev)
    x, mean, prec = mdsa_inputs(dev, 4, 16, seed=0)
    r, k, v, wd, u, s0 = scan_inputs(dev, 2, 4, 2, 64, torch.float32, seed=0)
    calls = {
        "gate_score": lambda: confidence_gate(logits),
        "gate_select": lambda: select(conf, None, None, 4),
        "fused_head_gate": lambda: fused_head_gate(hidden, w),
        "flash_attention": lambda: attention(q, q, q),
        "decode_attention": lambda: decode_attn(dq, kc, kc, lens),
        "maxconf": lambda: maxconf(logits),
        "mdsa": lambda: mdsa_distance(x.requires_grad_(), mean, prec),
        "rwkv6_scan": lambda: rwkv6_scan(r.requires_grad_(), k, v, wd, u,
                                         s0),
    }
    before = launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel "
                                               f"has no backward"):
            call()
    assert launch_counts() == before
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[n] > before[n] for n in calls)


@pytest.mark.parametrize("arch,tol", [("yi-6b", 1e-4), ("rwkv6-1.6b", 2e-3),
                                      ("zamba2-7b", 1e-4)])
def test_reduced_train_step_on_the_card(dev, arch, tol):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    gparams = tree_map(lambda a: a.to(dev), params)
    toks = np.random.default_rng(41).integers(1, cfg.vocab_size, (2, 64))
    before = launch_counts()
    lc, _, gc_ = value_and_grad(cfg, params, {"tokens": toks})
    lg, _, gg = value_and_grad(cfg, gparams, {"tokens": toks})
    torch.cuda.synchronize()
    assert launch_counts() == before
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for a, b in zip(tree_leaves(gg), tree_leaves(gc_)):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(
            a.cpu().numpy(), b.numpy(), rtol=0,
            atol=tol * float(b.abs().max()) + 1e-7)
    state = opt.init_opt_state(gparams)
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
    _, _, metrics = step(gparams, state, {"tokens": toks})
    torch.cuda.synchronize()
    assert state["step"] == 1 and np.isfinite(float(metrics["loss"]))
    assert launch_counts() == before
