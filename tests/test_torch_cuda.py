"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device every test skips (the fixture
decides at run time). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: pred and idx exact (inputs are checked for gaps first);
conf rtol 1e-4 / atol 1e-6 (fp32 online softmax summed in another order);
attention f32 atol 1e-4, bf16 atol 2e-2 against the plain version run in
f32 on the same bf16 inputs (one bf16 rounding of outputs of order 1).
TF32 is switched off so the plain versions compute in full fp32, as the
kernels do.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.confidence_gate.ops import confidence_gate  # noqa: E402
from repro_torch.kernels.confidence_gate.ref import confidence_gate_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_head_gate.ops import fused_head_gate  # noqa: E402
from repro_torch.kernels.fused_head_gate.ref import fused_head_gate_ref  # noqa: E402

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


def check_gate_out(got, want):
    torch.cuda.synchronize()
    assert torch.allclose(got["conf"], want["conf"], rtol=1e-4, atol=1e-6)
    assert torch.equal(got["pred"], want["pred"])
    assert torch.equal(got["idx"], want["idx"])


@pytest.mark.parametrize("sup", SUPERVISORS)
@pytest.mark.parametrize("b,c,dtype", [(8, 8, torch.float32),
                                       (13, 3000, torch.float32),
                                       (32, 64000, torch.bfloat16)])
def test_gate_kernel_matches_plain(dev, sup, b, c, dtype):
    rng = np.random.default_rng(b + c)
    x = rng.standard_normal((b, c)).astype(np.float32)
    # one planted maximum per row, heights spread so confidences differ
    # by more than the kernel's rounding at any vocabulary size
    base, step = (8.0, 0.25) if c > 10_000 else (4.0, 0.7)
    x[np.arange(b), rng.integers(0, c, b)] = base + step * rng.permutation(b)
    logits = torch.from_numpy(x).to(dev).to(dtype)
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


@pytest.mark.parametrize("b,d,c,wdt", [(8, 32, 8, torch.float32),
                                       (40, 96, 700, torch.bfloat16),
                                       (32, 4096, 8000, torch.bfloat16)])
def test_fused_head_kernel_matches_plain(dev, b, d, c, wdt):
    rng = np.random.default_rng(b * d + c)
    h = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, c)) * 3
                          / np.sqrt(d)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    h, w, bias = h.to(dev), w.to(dev).to(wdt), bias.to(dev)
    t = gapped(fused_head_gate_ref(h, w, bias)["conf"], b, gap=1e-6)
    check_gate_out(fused_head_gate(h, w, bias, t, b - 1),
                   fused_head_gate_ref(h, w, bias, t, b - 1))


@pytest.mark.parametrize("b,t,h,kh,hd,window,dtype", [
    (2, 48, 32, 4, 128, 0, torch.bfloat16),
    (1, 130, 8, 2, 64, 0, torch.float32),
    (2, 77, 4, 4, 128, 16, torch.float32),
])
def test_flash_kernel_matches_plain(dev, b, t, h, kh, hd, window, dtype):
    rng = np.random.default_rng(t + h)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, t, n, hd)).astype(np.float32)).to(dev)
    q, k, v = mk(h).to(dtype), mk(kh).to(dtype), mk(kh).to(dtype)
    got = attention(q, k, v, causal=True, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=True,
                         window=window)
    torch.cuda.synchronize()
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= atol


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        confidence_gate(torch.zeros(4, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        confidence_gate(torch.zeros(8, 4, device=dev).t())
    q = torch.zeros(1, 8, 4, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        attention(q, q, q)
    # a callable supervisor has no kernel yet: never the plain version
    margin = lambda lg: lg.max(-1).values - lg.mean(-1)  # noqa: E731
    with pytest.raises(ValueError, match="softmax family"):
        confidence_gate(torch.zeros(4, 8, device=dev), supervisor=margin)
