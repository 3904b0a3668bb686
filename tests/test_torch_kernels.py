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
the two sum in another order in f32. The CUDA statistics pass's own
arithmetic (``csrc/vocab_stats.cuh``: register blocks of 8 logits, one
bf16 or two f32 16-byte loads, per-thread strides, lane and warp trees,
cluster ranks merged in order),
emulated in f32, is held to the Pallas kernel at the card's tolerances
(``chip_smoke.py``'s ``check_gate``): conf rtol 1e-4 / atol 1e-6, pred
exact.
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
from repro_torch.kernels.confidence_gate.kernel import (  # noqa: E402
    MAX_CLUSTER, SM_COUNT, STATS_ROWS_PER_BLOCK, STATS_THREADS, WIDE_COLS,
    stats_plan)
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


# ------------------------------------------ the statistics pass's arithmetic

NEG = -1e30
LOG2E = 1.4426950408889634
VEC = {"float32": 4, "bfloat16": 8}        # elements in one 16-byte load
KEYS = ("m1", "m2", "s", "t", "s2", "a1")


def _empty(shape) -> dict:
    z = torch.zeros(shape)
    return {"m1": torch.full(shape, NEG), "m2": torch.full(shape, NEG),
            "s": z, "t": z, "s2": z,
            "a1": torch.full(shape, 2**31 - 1, dtype=torch.int64)}


def _merge(a: dict, b: dict, where=None) -> dict:
    """b merged into a as vstats::merge does (one exp; first index on
    ties); only where ``where`` holds."""
    a_hi = a["m1"] >= b["m1"]
    hi = torch.where(a_hi, a["m1"], b["m1"])
    lo = torch.where(a_hi, b["m1"], a["m1"])
    c = torch.exp2((lo - hi) * LOG2E)
    ca, cb = torch.where(a_hi, 1.0, c), torch.where(a_hi, c, 1.0)
    take_b = (b["m1"] > a["m1"]) | ((b["m1"] == a["m1"]) & (b["a1"] < a["a1"]))
    r = {"m1": hi, "m2": torch.maximum(lo, torch.maximum(a["m2"], b["m2"])),
         "s": a["s"] * ca + b["s"] * cb, "t": a["t"] * ca + b["t"] * cb,
         "s2": a["s2"] * ca * ca + b["s2"] * cb * cb,
         "a1": torch.where(take_b, b["a1"], a["a1"])}
    if where is None:
        return r
    return {k: torch.where(where, r[k], a[k]) for k in KEYS}


def _fold(st: dict, x: torch.Tensor, cols: torch.Tensor, valid) -> dict:
    """A register block x [..., N] at columns cols [..., N] (increasing;
    masked logits hold NEG) folded into st as vstats::fold does: block
    max and first argmax, second max with the argmax masked, one exp per
    element against the block max, summed in column order, then one
    merge."""
    bi = x.argmax(-1)
    bm1 = x.gather(-1, bi[..., None])[..., 0]
    masked = torch.where(torch.arange(x.shape[-1]) == bi[..., None], NEG, x)
    e = torch.exp2((x - bm1[..., None]) * LOG2E)
    s = t = s2 = torch.zeros(bm1.shape)
    for i in range(x.shape[-1]):
        s = s + e[..., i]
        t = t + e[..., i] * x[..., i]
        s2 = s2 + e[..., i] * e[..., i]
    blk = {"m1": bm1, "m2": masked.amax(-1), "s": s, "t": t, "s2": s2,
           "a1": torch.broadcast_to(cols, x.shape).gather(-1, bi[..., None])[
               ..., 0]}
    return _merge(st, blk, valid)


def _tree(st: dict) -> dict:
    """[rows, 32] lanes reduced as a shuffle-down tree; lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        m = _merge({k: v[:, :32 - off] for k, v in st.items()},
                   {k: v[:, off:] for k, v in st.items()})
        st = {k: torch.cat([m[k], st[k][:, 32 - off:]], 1) for k in KEYS}
    return {k: v[:, 0] for k, v in st.items()}


def stats_emulated(x: torch.Tensor, vec: int, cluster: int,
                   head: int = 0) -> dict:
    """The statistics of each row of x [B, C] (f32 values) as
    vocab_stats_kernel computes them, in f32: a row whose first ``head``
    columns lie before its first 16-byte boundary, ``cluster`` blocks of
    STATS_THREADS threads per row (0: one warp). Thread i of the row's
    first block folds head column i first, then its vectors (every nt-th
    of its block's run) in order, 8 logits to a register block (two f32
    vectors, nt apart, the second masked past the run), its even blocks
    into one running statistics and its odd blocks into another, merged
    after the last, and thread i of the last block the tail column after
    the vectors; lanes merge by a shuffle tree, warps by another, ranks
    in order."""
    b, c = x.shape
    head = min(c, head)
    nvec = (c - head) // vec
    tail0 = head + nvec * vec
    ranks, nt = (1, 32) if cluster == 0 else (cluster, STATS_THREADS)
    per = -(-nvec // ranks)
    body = x[:, head:tail0].reshape(b, nvec, vec)
    tid = torch.arange(nt)
    one = tid.clamp(max=c - 1)
    out = None
    for r in range(ranks):
        st = _empty((b, nt))
        if r == 0:
            st = _fold(st, x[:, one][..., None], tid[:, None], tid < head)
        v0 = min(nvec, r * per)
        v1 = min(nvec, v0 + per)
        loads = 8 // vec                    # 16-byte loads per block
        acc = [st, _empty((b, nt))]         # even and odd blocks
        for k in range(0, -(-(v1 - v0) // nt), loads):
            vis = [v0 + (k + j) * nt + tid for j in range(loads)]
            blk = torch.cat([torch.where((vi < v1)[:, None],
                                         body[:, vi.clamp(max=nvec - 1)], NEG)
                             for vi in vis], -1)
            cols = torch.cat([(head + vi * vec)[:, None] + torch.arange(vec)
                              for vi in vis], -1)
            j = k // loads % 2
            acc[j] = _fold(acc[j], blk, cols, vis[0] < v1)
        st = _merge(*acc)
        if r == ranks - 1:
            cols = (tail0 + tid).clamp(max=c - 1)
            st = _fold(st, x[:, cols][..., None], (tail0 + tid)[:, None],
                       tid < c - tail0)
        if nt == 32:
            st = _tree(st)
        else:
            warps = [_tree({k: v[:, w * 32:(w + 1) * 32]
                            for k, v in st.items()})
                     for w in range(nt // 32)]
            lanes = {k: torch.stack([w[k] for w in warps], 1)
                     for k in KEYS}
            pad = _empty((b, 32 - len(warps)))
            st = _tree({k: torch.cat([lanes[k], pad[k]], 1) for k in KEYS})
        out = st if out is None else _merge(out, st)
    return out


def gate_conf_emulated(st: dict, sup: str) -> torch.Tensor:
    """gate_conf of gate_stats.cuh on emulated statistics."""
    z = st["s"]
    return {"max_softmax": lambda: 1.0 / z,
            "pcs": lambda: (1.0 - torch.exp(st["m2"] - st["m1"])) / z,
            "neg_entropy": lambda: st["t"] / z - (st["m1"] + torch.log(z)),
            "gini": lambda: st["s2"] / (z * z)}[sup]()


def tied_logits(seed: int, b: int, c: int, vec: int, cluster: int,
                head: int, dtype: str) -> np.ndarray:
    """Normal logits (scale 3) where row r's maximum appears at two
    columns, the first index to win: row 0 across a cluster rank's (or,
    for one warp per row, a lane's) boundary, row 1 inside one register
    block, row 2 across two neighbouring blocks (two threads), row 3 at
    the first and the last column (a pair past the row's end falls back
    to that one), row 4 across one thread's two loads (an f32 register
    block's halves); further rows hold one maximum."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c)) * 3).astype(np.float32)
    head = min(c, head)
    nvec = (c - head) // vec
    per = -(-nvec // max(cluster, 1)) if cluster else 1
    edge = head + per * vec                 # first column of rank/lane 1
    nt = 32 if cluster == 0 else STATS_THREADS
    pairs = [(edge - 1, edge), (head + 1, head + 2),
             (head + vec - 1, head + vec), (0, c - 1),
             (head, head + nt * vec)]     # one thread's next load
    for r in range(b):
        i, j = pairs[r] if r < len(pairs) else (int(rng.integers(c)),) * 2
        if j >= c:
            i, j = 0, c - 1
        x[r, [i, j]] = x[r].max() + 1.0 + r
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) \
        if dtype == "bfloat16" else x


# (b, c, dtype, cluster, head): narrow rows a warp each and wide rows a
# cluster each, rows aligned or not, C a multiple of the vector or not
STATS_CASES = [
    (4, 8, "float32", 0, 0),          # the serve path's [32, 8], cut
    (5, 301, "float32", 0, 3),        # C % 4 = 1, a 3-column head
    (4, 3001, "bfloat16", 0, 5),      # odd C in bf16, a 5-column head
    (3, 3, "float32", 0, 1),          # C below one vector
    (2, 1, "float32", 0, 0),          # C = 1
    (4, 4099, "float32", 3, 1),       # 3 ranks, ragged, unaligned
    (5, 9001, "bfloat16", 2, 0),      # 2 ranks of 8-wide blocks
    (4, 4096, "float32", 8, 0),       # 8 ranks, some holding one vector
]


@pytest.mark.parametrize("sup", SUPERVISORS)
@pytest.mark.parametrize("b,c,dtype,cluster,head", STATS_CASES)
def test_gate_score_kernel_arithmetic_matches_jax(sup, b, c, dtype, cluster,
                                                  head):
    """The CUDA score's fold order and merges, emulated in f32, against
    the JAX gate's Pallas kernel (interpret mode): pred exact (first
    index on every planted tie), conf within rtol 1e-4 / atol 1e-6."""
    x = tied_logits(b + c, b, c, VEC[dtype], cluster, head, dtype)
    st = stats_emulated(torch.from_numpy(x), VEC[dtype], cluster, head)
    want = jax_gate(jnp.asarray(x, jnp.dtype(dtype)), supervisor=sup,
                    force_pallas=True, interpret=True)
    np.testing.assert_array_equal(st["a1"].numpy(), np.asarray(want["pred"]))
    np.testing.assert_array_equal(st["a1"].numpy(), np.argmax(x, 1))
    np.testing.assert_allclose(gate_conf_emulated(st, sup).numpy(),
                               np.asarray(want["conf"]), rtol=1e-4,
                               atol=1e-6)


def test_gate_score_kernel_arithmetic_on_extreme_logits():
    """Logits of +-1e4 and a row of ties at 0: finite statistics, the
    first index, and conf as the Pallas kernel gives it."""
    x = np.zeros((2, 4100), np.float32)
    x[0, :3] = [1e4, -1e4, 0.0]
    x[1, 5] = x[1, 77] = -1e4
    for cluster, head in ((0, 0), (3, 2)):
        st = stats_emulated(torch.from_numpy(x), 4, cluster, head)
        assert st["a1"].tolist() == [0, 0]
        for sup in SUPERVISORS:
            want = jax_gate(jnp.asarray(x), supervisor=sup,
                            force_pallas=True, interpret=True)
            conf = gate_conf_emulated(st, sup).numpy()
            assert np.isfinite(conf).all()
            np.testing.assert_allclose(conf, np.asarray(want["conf"]),
                                       rtol=1e-4, atol=1e-6)


def kernel_columns(c: int, head: int, vec: int, cluster: int) -> dict:
    """The columns each (rank, thread) of a row folds, in its order, as
    vocab_stats_kernel splits the row (cluster 0: one warp's lanes)."""
    ranks, nt = (1, 32) if cluster == 0 else (cluster, STATS_THREADS)
    head = min(c, head)
    nvec = (c - head) // vec
    tail0 = head + nvec * vec
    per = -(-nvec // ranks)
    out = {}
    for r in range(ranks):
        v0 = min(nvec, r * per)
        v1 = min(nvec, v0 + per)
        for t in range(nt):
            cols = [t] if r == 0 and t < head else []
            for v in range(v0 + t, v1, nt):
                cols += range(head + v * vec, head + (v + 1) * vec)
            if r == ranks - 1 and t < c - tail0:
                cols.append(tail0 + t)
            out[r, t] = cols
    return out


@pytest.mark.parametrize("b", [1, 8, 32, 133])
@pytest.mark.parametrize("c", [1, 8, 3001, 4095, 4096, 64000, 152064])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_plan_covers_every_column_once(b, c, dtype):
    """Narrow rows get one warp each; a wide row a cluster that divides
    the grid, no larger than the portable 8, with a 16-byte load for
    every thread and, where it has more than one block, no more blocks
    than SMs; and for any alignment of the row every column is folded by
    exactly one thread, in increasing order."""
    p = stats_plan(b, c, dtype)
    assert stats_plan(b, c, dtype) is p                 # cached per shape
    vec = 16 // dtype.itemsize
    if c < WIDE_COLS:
        assert p.cluster == 0
        assert p.grid == -(-b // STATS_ROWS_PER_BLOCK)
    else:
        assert 1 <= p.cluster <= MAX_CLUSTER and p.grid == p.cluster * b
        assert p.cluster == 1 or (c >= p.cluster * STATS_THREADS * vec
                                  and p.grid <= SM_COUNT)
    if c > 5000:
        return      # the split is checked at the narrow and wide edges
    for head in range(vec):
        cols = kernel_columns(c, head, vec, p.cluster)
        seen = [col for run in cols.values() for col in run]
        assert sorted(seen) == list(range(c))
        assert all(run == sorted(run) for run in cols.values())
