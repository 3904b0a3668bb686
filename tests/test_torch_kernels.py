"""Kernel packages of the PyTorch port against the JAX package.

On the CPU each port wrapper runs its plain PyTorch version (``ref.py``);
the JAX side runs its Pallas kernel in interpret mode (``force_pallas=True,
interpret=True``), as the JAX package's own tests do. Inputs come from
numpy seeds and reach both packages as the same numbers. The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: integer outputs (pred, idx) must be equal. conf is held to
1e-4 (rtol and atol): the Pallas kernel folds classes in blocks with an
online softmax and the port's plain version calls ``torch.softmax``, so
the two sum in another order in f32.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.confidence_gate.ops import confidence_gate as jax_gate  # noqa: E402
from repro.kernels.fused_head_gate.ops import FusedLocalHead as JaxHead  # noqa: E402
from repro.kernels.fused_head_gate.ops import fused_head_gate as jax_head_gate  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.confidence_gate.ops import confidence_gate  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.fused_head_gate.ops import (FusedLocalHead,  # noqa: E402
                                                     fused_head_gate)
from repro_torch.weights import params_from_jax  # noqa: E402

SUPERVISORS = ("max_softmax", "pcs", "neg_entropy", "gini")
CONF_TOL = 1e-4


def t_(a):
    """numpy (incl. ml_dtypes bfloat16) -> CPU torch tensor."""
    return params_from_jax(np.asarray(a), "cpu")


def gap_threshold(conf: np.ndarray, n_valid: int) -> float:
    """A t_local in the widest gap of the valid confidences' middle half;
    asserts the gap exceeds the tolerance, so a failure names the inputs
    rather than the port."""
    c = np.sort(conf[:n_valid].astype(np.float64))
    lo, hi = len(c) // 4, max(len(c) // 4 + 1, 3 * len(c) // 4)
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    assert c[i + 1] - c[i] > 10 * CONF_TOL, "inputs: no conf gap at t_local"
    return float((c[i] + c[i + 1]) / 2)


def logits_for(seed: int, b: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 4.0, (b, 1))          # spread the confidences
    return (rng.standard_normal((b, c)) * scale).astype(np.float32)


# ------------------------------------------------------------ confidence gate

GATE_CASES = [  # (b, c, threshold?, n_valid)
    (8, 128, False, None),
    (13, 200, True, 10),      # ragged rows and classes (padding on TPU)
    (32, 8, True, 29),        # the serving path's [B, classes]
    (6, 1000, True, None),
]


@pytest.mark.parametrize("sup", SUPERVISORS)
@pytest.mark.parametrize("b,c,thr,n_valid", GATE_CASES)
def test_gate_matches_jax_pallas(sup, b, c, thr, n_valid):
    x = logits_for(b * 1000 + c, b, c)
    n_eff = b if n_valid is None else n_valid
    conf = confidence_gate(t_(x), supervisor=sup)["conf"].numpy()
    t_local = gap_threshold(conf, n_eff) if thr else None
    want = jax_gate(jnp.asarray(x), t_local, n_valid, supervisor=sup,
                    force_pallas=True, interpret=True)
    got = confidence_gate(t_(x), t_local, n_valid, supervisor=sup)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]),
                               rtol=CONF_TOL, atol=CONF_TOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    assert got["idx"].dtype == torch.int32 and got["pred"].dtype == torch.int32


@pytest.mark.parametrize("k", [1, 3, 6])
def test_gate_k_limits_candidates(k):
    x = logits_for(5, 12, 64)
    want = jax_gate(jnp.asarray(x), k=k, force_pallas=True, interpret=True)
    got = confidence_gate(t_(x), k=k)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))


def test_gate_ties_take_first_index():
    """Rows 1, 3 and 4 are identical (equal confidence) and row 5 holds
    two equal maxima: idx lists tied rows lower index first and pred is
    the first maximal column, in both packages."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    x[3] = x[1]
    x[4] = x[1]
    x[5, 2] = x[5, 9] = x[5].max() + 1.0
    x[[0, 2, 6, 7]] *= 0.1                    # low confidence: ranked first
    want = jax_gate(jnp.asarray(x), force_pallas=True, interpret=True)
    got = confidence_gate(t_(x))
    idx = got["idx"].tolist()
    assert idx.index(1) < idx.index(3) < idx.index(4)
    assert int(got["pred"][5]) == 2
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))


def test_gate_threshold_and_padding_rows_excluded():
    x = logits_for(9, 10, 32)
    conf = confidence_gate(t_(x))["conf"].numpy()
    t_local = gap_threshold(conf, 7)
    got = confidence_gate(t_(x), t_local, 7)["idx"].numpy()
    sel = got[got >= 0]
    assert np.all(sel < 7) and np.all(conf[sel] < t_local)
    assert np.all(np.diff(conf[sel]) >= 0)
    assert np.all(got[len(sel):] == -1)


def test_gate_accepts_device_scalars():
    x = logits_for(4, 9, 40)
    a = confidence_gate(t_(x), 0.5, 6)
    n = torch.tensor(6, dtype=torch.int32)
    b = confidence_gate(t_(x), torch.tensor(0.5), n)
    assert torch.equal(a["idx"], b["idx"])


def test_gate_callable_supervisor():
    x = logits_for(2, 7, 16)
    margin = lambda lg: lg.max(-1).values - lg.mean(-1)  # noqa: E731
    jmargin = lambda lg: lg.max(-1) - lg.mean(-1)  # noqa: E731
    got = confidence_gate(t_(x), supervisor=margin, k=4)
    want = jax_gate(jnp.asarray(x), supervisor=jmargin, k=4)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))


def test_cpu_tensors_never_count_launches():
    before = launch_counts()
    confidence_gate(t_(logits_for(1, 4, 8)))
    attention(*(torch.zeros(1, 4, 2, 64) for _ in range(3)))
    assert launch_counts() == before


def test_launch_counts_lose_nothing_across_threads():
    """The transport launches the remote tier's kernels from its worker
    threads: concurrent counts must all land."""
    import threading

    from repro_torch.kernels.build import count_launch
    counter = {"k": 0}

    def work():
        for _ in range(20_000):
            count_launch(counter, "k")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter["k"] == 8 * 20_000


# ---------------------------------------------------------- fused head gate

HEAD_CASES = [  # (b, d, c, w dtype, bias?, threshold?, n_valid)
    (8, 32, 8, "float32", True, False, None),      # the surrogate's head
    (13, 48, 300, "float32", True, True, 11),      # ragged, thresholded
    (16, 64, 130, "bfloat16", False, True, None),  # bf16 weights, no bias
    (32, 32, 8, "float32", True, True, 29),        # the serving path
]


@pytest.mark.parametrize("sup", ["max_softmax", "neg_entropy"])
@pytest.mark.parametrize("b,d,c,wdt,use_bias,thr,n_valid", HEAD_CASES)
def test_fused_head_gate_matches_jax_pallas(sup, b, d, c, wdt, use_bias, thr,
                                            n_valid):
    rng = np.random.default_rng(b + d + c)
    h = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.standard_normal((d, c)) * rng.uniform(0.2, 1.0, (1, c))
         * 3 / np.sqrt(d)).astype(np.float32)
    if wdt == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32) \
        if use_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    n_eff = b if n_valid is None else n_valid
    conf = fused_head_gate(t_(h), t_(w), None if bias is None else t_(bias),
                           supervisor=sup)["conf"].numpy()
    t_local = gap_threshold(conf, n_eff) if thr else None
    want = jax_head_gate(jnp.asarray(h), jnp.asarray(w), jb, t_local,
                         n_valid, supervisor=sup, force_pallas=True,
                         interpret=True)
    got = fused_head_gate(t_(h), t_(w), None if bias is None else t_(bias),
                          t_local, n_valid, supervisor=sup)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]),
                               rtol=CONF_TOL, atol=CONF_TOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))


def test_fused_local_head_is_a_drop_in_local_apply():
    """Calling a FusedLocalHead composes trunk + projection like the JAX
    carrier, and the fused op on its pieces equals the gate on those
    logits."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((6, 12)).astype(np.float32)
    wt = rng.standard_normal((12, 10)).astype(np.float32)
    w = rng.standard_normal((10, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    head = FusedLocalHead(lambda a: torch.tanh(a @ t_(wt)), t_(w), t_(bias))
    jhead = JaxHead(lambda a: jnp.tanh(a @ jnp.asarray(wt)), jnp.asarray(w),
                    jnp.asarray(bias))
    np.testing.assert_allclose(head(t_(x)).numpy(),
                               np.asarray(jhead(jnp.asarray(x))), atol=1e-5)
    fused = fused_head_gate(head.trunk(t_(x)), head.w, head.bias)
    plain = confidence_gate(head(t_(x)))
    for key in ("conf", "pred", "idx"):
        assert torch.equal(fused[key], plain[key]), key


def test_fused_head_gate_rejects_mismatched_dims():
    with pytest.raises(ValueError, match="head dim"):
        fused_head_gate(torch.zeros(2, 3), torch.zeros(4, 5))
