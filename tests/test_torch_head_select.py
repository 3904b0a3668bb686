"""The arithmetic of the gate's select kernel and of the fused head
gate's wide form (``csrc/confidence_gate.cu``, ``csrc/fused_head_gate.cu``)
emulated on the CPU and held to the JAX package.

The select ranks rows by an order-preserving uint32 image of each
confidence (made canonical first, so -0.0 ties +0.0; NaN above +inf)
with the row index in the low word: one pass, no rounds. Its emulation
is held exactly to the JAX Pallas select (``_select_kernel``, interpret
mode, called as ``confidence_gate_pallas`` calls it) and to the port's
plain ``select_ref`` on ties, padding rows, a confidence equal to
``t_local``, k below the number of eligible rows and k = B. Where a NaN
is the minimum the Pallas select takes no row at all (``jnp.min``
propagates the NaN), while the JAX package's oracle orders NaN last, as
a stable argsort does: the port follows the oracle, and the divergence
is pinned below.

The head gate's tensor-core form splits an f32 hidden value into three
bf16 pieces whose sum is the value exactly, takes each 16-deep step's
products in a fresh accumulator and adds the steps in fp32, then folds
each thread's register block of logits (+ bias) and merges lanes, warps,
cluster ranks and clusters in a fixed order. The emulation idealises the
tensor core's sum of a step as one rounding of the exact sum; it is held
to the Pallas head gate (interpret mode) at the card's tolerances: conf
rtol 1e-4 / atol 1e-6, pred exact (first index on planted ties).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.kernels.confidence_gate.kernel import (  # noqa: E402
    _select_kernel, confidence_gate_pallas)
from repro.kernels.confidence_gate.ref import \
    confidence_gate_ref as jax_gate_ref  # noqa: E402
from repro.kernels.fused_head_gate.kernel import \
    fused_head_gate_pallas  # noqa: E402
from repro.kernels.fused_head_gate.ops import \
    fused_head_gate as jax_head_gate  # noqa: E402
from repro_torch.kernels.confidence_gate.ops import confidence_gate  # noqa: E402
from repro_torch.kernels.confidence_gate.ref import select_ref  # noqa: E402
from repro_torch.kernels.fused_head_gate.kernel import (  # noqa: E402
    FMA_TILE_COLS, HEAD_CLUSTER, HEAD_ROWS, MMA_WARP_COLS, MMA_WARPS,
    NARROW_COLS, head_plan)
from tests.test_torch_kernels import (_empty, _fold, _merge,  # noqa: E402
                                      _tree, gate_conf_emulated)

SUPERVISORS = ("max_softmax", "pcs", "neg_entropy", "gini")


# ----------------------------------------------------------------- select

def order_key(conf: np.ndarray) -> np.ndarray:
    """order_key of confidence_gate.cu: the canonical value's bits
    (-0.0 + 0.0 = +0.0), negatives reversed below the positives, NaN
    above +inf."""
    c = conf.astype(np.float32) + np.float32(0.0)
    bits = c.view(np.uint32)
    key = np.where(bits & 0x80000000, ~bits, bits | 0x80000000)
    return np.where(np.isnan(c), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def key_value(key: np.ndarray) -> np.ndarray:
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key)
    return bits.astype(np.uint32).view(np.float32)


def rank_select_emulated(conf: np.ndarray, t_local: float, n_valid: int,
                         k: int) -> np.ndarray:
    """The sort form: 64-bit keys (order_key << 32 | row) sorted, slot r
    the row of rank r if its value is below t_local, else -1."""
    b = conf.shape[0]
    masked = np.where(np.arange(b) < n_valid, conf, np.float32(np.inf))
    keys = (order_key(masked).astype(np.uint64) << np.uint64(32)
            | np.arange(b, dtype=np.uint64))
    top = np.sort(keys)[:k]
    rows = (top & np.uint64(0xFFFFFFFF)).astype(np.int32)
    vals = key_value((top >> np.uint64(32)).astype(np.uint32))
    return np.where(vals < np.float32(t_local), rows, -1).astype(np.int32)


def rank_select_warp_emulated(conf: np.ndarray, t_local: float,
                              n_valid: int, k: int) -> np.ndarray:
    """The warp form (B <= 32): lane i counts the rows ordering before
    its own (smaller key, or an equal key at a lower index), writes
    idx[rank] = i when taken; the slots from the taken count to k - 1
    get -1."""
    b = conf.shape[0]
    v = np.where(np.arange(b) < n_valid, conf, np.float32(np.inf))
    key = order_key(v).astype(np.int64)
    lane = np.arange(b)
    rank = ((key[None, :] < key[:, None])
            | ((key[None, :] == key[:, None])
               & (lane[None, :] < lane[:, None]))).sum(1)
    take = v < np.float32(t_local)
    idx = np.full(k, -7, np.int32)
    for i in lane[take & (rank < k)]:
        idx[rank[i]] = i
    idx[take.sum():] = -1
    return idx


def jax_select(conf: np.ndarray, t_local: float, n_valid: int,
               k: int) -> np.ndarray:
    """The JAX package's Pallas select on these confidences, in interpret
    mode, padded and called as ``confidence_gate_pallas`` calls it."""
    b = conf.shape[0]
    bp = b + (-b) % 128
    row = jnp.full((1, bp), jnp.inf, jnp.float32).at[0, :b].set(conf)
    idx = pl.pallas_call(
        functools.partial(_select_kernel, k=k, bp=bp),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((k,), jnp.int32),
        interpret=True,
    )(jnp.asarray(t_local, jnp.float32).reshape(1),
      jnp.asarray(n_valid, jnp.int32).reshape(1), row)
    return np.asarray(idx)


def select_case(name: str):
    """(conf, t_local, n_valid, k) of a named edge case, no NaN."""
    rng = np.random.default_rng(len(name))
    c = rng.random(40).astype(np.float32)
    if name == "ties":                      # equal values: lower row first
        c[[3, 17, 30, 31]] = c[9]
        return c, np.inf, 40, 40
    if name == "zeros":                     # -0.0 and +0.0 tie
        c[[5, 2, 33]] = [-0.0, 0.0, -0.0]
        return c, 0.5, 40, 40
    if name == "padding":                   # rows >= n_valid never taken
        c[35:] = 0.0
        return c, np.inf, 35, 40
    if name == "equal_t":                   # conf == t_local is not taken
        c[[4, 8]] = np.float32(0.25)
        return c, float(np.float32(0.25)), 40, 40
    if name == "k_below_eligible":
        return c, 0.9, 40, 6
    if name == "inf":                       # +inf never taken, even at +inf
        c[[0, 7]] = np.inf
        c[11] = -np.inf
        return c, np.inf, 40, 40
    if name == "all_taken_k_eq_b":
        return c, 2.0, 40, 40
    raise KeyError(name)


SELECT_CASES = ("ties", "zeros", "padding", "equal_t", "k_below_eligible",
                "inf", "all_taken_k_eq_b")


@pytest.mark.parametrize("b", [40, 32, 7])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_rank_select_emulation_matches_jax_pallas_and_ref(case, b):
    """Both select forms, emulated, equal the Pallas select and the
    port's select_ref exactly (B = 40 exercises the sort form's
    arithmetic, 32 and 7 the warp form's)."""
    conf, t, n, k = select_case(case)
    conf, n, k = conf[:b], min(n, b), min(k, b)
    want = jax_select(conf, t, n, k)
    ref = select_ref(torch.from_numpy(conf), t, n, k).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(rank_select_emulated(conf, t, n, k), want)
    if b <= 32:
        np.testing.assert_array_equal(
            rank_select_warp_emulated(conf, t, n, k), want)


def test_order_key_orders_as_comparison_does():
    """Keys compare as < and == on every pair of non-NaN values (the
    zeros and infinities included) and put NaN last."""
    vals = np.array([-np.inf, -3.5, -1e-30, -1e-45, -0.0, 0.0, 1e-45,
                     1e-30, 0.25, 3.5, 3.4028235e38, np.inf], np.float32)
    key = order_key(vals).astype(np.int64)
    for i, a in enumerate(vals):
        for j, b in enumerate(vals):
            assert (key[i] < key[j]) == (a < b), (a, b)
            assert (key[i] == key[j]) == (a == b), (a, b)
    assert order_key(np.array([np.nan, -np.nan], np.float32)).tolist() \
        == [0xFFFFFFFF] * 2
    assert (key < 0xFFFFFFFF).all()
    back = key_value(order_key(vals))
    np.testing.assert_array_equal(back, vals + np.float32(0.0))


def test_select_pins_nan_to_the_oracle_not_the_pallas_select():
    """Logits [8, 128] with row 2 all NaN, t_local 0.9, n_valid 8, k 8:
    the JAX Pallas select returns no row (its minimum is NaN in every
    round, so nothing is taken: the recorded divergence), the JAX
    package's oracle orders the NaN row last and never takes it; the
    port's plain version and both emulated select forms follow the
    oracle."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    x[[0, 3, 4, 5]] *= 0.05                 # low confidence: taken
    x[2] = np.nan
    pallas = confidence_gate_pallas(jnp.asarray(x), jnp.float32(0.9),
                                    jnp.int32(8), supervisor="max_softmax",
                                    k=8, interpret=True)
    assert np.asarray(pallas["idx"]).tolist() == [-1] * 8
    oracle = np.asarray(jax_gate_ref(jnp.asarray(x), 0.9, 8, k=8)["idx"])
    port = confidence_gate(torch.from_numpy(x), 0.9, 8, k=8)
    np.testing.assert_array_equal(port["idx"].numpy(), oracle)
    conf = port["conf"].numpy()
    assert np.isnan(conf[2]) and 2 not in oracle.tolist()
    assert (oracle[:4] >= 0).all()
    np.testing.assert_array_equal(rank_select_emulated(conf, 0.9, 8, 8),
                                  oracle)
    np.testing.assert_array_equal(rank_select_warp_emulated(conf, 0.9, 8, 8),
                                  oracle)


# ------------------------------------------------ head gate: bf16 pieces

def bf16_pieces(h: torch.Tensor) -> list[torch.Tensor]:
    """h0 = bf16(h), h1 = bf16(h - h0), h2 = bf16(h - h0 - h1) as f32
    (each difference exact in fp32; round to nearest even, as
    __float2bfloat16_rn)."""
    h0 = h.bfloat16().float()
    r1 = h - h0
    h1 = r1.bfloat16().float()
    h2 = (r1 - h1).bfloat16().float()
    return [h0, h1, h2]


@pytest.mark.parametrize("exponents", [(-110, -60), (-20, 20), (60, 126)])
def test_three_bf16_pieces_sum_to_the_f32_value_bit_for_bit(exponents):
    """h0 + h1 + h2 == h exactly for f32 values of magnitude 2^-110 and
    up (random mantissas and signs, binary exponents drawn from the
    range), each piece exactly a bf16; below 2^-110 the last piece can
    fall under bf16's normal range and round."""
    rng = np.random.default_rng(exponents[0] + 200)
    n = 100_000
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    expo = rng.integers(exponents[0], exponents[1], n) + 127
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    bits = sign | (expo.astype(np.uint32) << 23) | mant
    h = torch.from_numpy(bits.view(np.float32).copy())
    p = bf16_pieces(h)
    for q in p:
        assert torch.equal(q.bfloat16().float(), q)
    total = (p[0] + p[1]) + p[2]
    assert torch.equal(total.view(torch.int32), h.view(torch.int32))
    # and their products with a bf16 weight are exact in fp32 wherever
    # the product is a normal f32
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    w = w.bfloat16().float()
    for q in p:
        prod = q.double() * w.double()
        normal = prod.abs() >= 2.0 ** -126
        assert torch.equal(prod.float().double()[normal], prod[normal])


def head_logits_emulated(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         pieces: int) -> torch.Tensor:
    """logits [B, C] as the tensor-core form computes them: per 16-deep
    step the pieces' products (smallest piece first) in a fresh
    accumulator, idealised as one f32 rounding of their exact sum, the
    steps added in order in fp32; then + bias in fp32."""
    b, d = h.shape
    ps = bf16_pieces(h) if pieces == 3 else [h.bfloat16().float()]
    acc = torch.zeros(b, w.shape[1])
    wd = w.double()
    for k0 in range(0, d, 16):
        step = sum(p[:, k0:k0 + 16].double() @ wd[k0:k0 + 16]
                   for p in reversed(ps))
        acc = acc + step.float()
    return acc + bias


def block_columns(c: int, mt: int, grid: int) -> list[tuple[int, int]]:
    """The tensor-core form's column range [c0, c1) of each block: 128 MT
    columns from 128 MT x (the grid's padding blocks own none)."""
    bm = MMA_WARPS * MMA_WARP_COLS * mt
    return [(min(c, x * bm), min(c, (x + 1) * bm)) for x in range(grid)]


def head_stats_emulated(logits: torch.Tensor, mt: int, cluster: int,
                        grid: int) -> dict:
    """The tensor-core form's epilogue and merges on logits [B, C] (+ bias
    already): block x owns columns c0 .. c1 - 1 (block_columns), warp w
    16 MT of them from c0 + w 16 MT; thread g (lane // 4) folds columns
    g + 8 i (i < 2 MT) of each row below c1 as one register block; the 8
    lanes of a row merge as g += g + 4, g + 2, g + 1; warps in order; the
    cluster's ranks in order; clusters in order."""
    b, c = logits.shape
    blocks = []
    for c0, c1 in block_columns(c, mt, grid):
        warps = []
        for wi in range(MMA_WARPS):
            wc0 = c0 + wi * MMA_WARP_COLS * mt
            lanes = []
            for g in range(8):
                cols = wc0 + g + 8 * torch.arange(2 * mt)
                ok = cols < c1
                vals = torch.where(ok, logits[:, cols.clamp(max=c - 1)],
                                   torch.tensor(-1e30))
                st = _fold(_empty((b,)), vals, cols[None].expand(b, -1),
                           torch.full((b,), bool(ok[0])))
                lanes.append(st)
            for off in (4, 2, 1):
                for g in range(off):
                    lanes[g] = _merge(lanes[g], lanes[g + off])
            warps.append(lanes[0])
        st = warps[0]
        for other in warps[1:]:
            st = _merge(st, other)
        blocks.append(st)
    clusters = []
    for cl in range(0, grid, cluster):
        st = blocks[cl]
        for other in blocks[cl + 1:cl + cluster]:
            st = _merge(st, other)
        clusters.append(st)
    out = clusters[0]
    for other in clusters[1:]:
        out = _merge(out, other)
    return out


def planted_head(seed: int, b: int, d: int, c: int, mt: int, grid: int,
                 pieces: int):
    """h [B, D] (bf16 values for one piece), w [D, C] (bf16 values),
    bias [C], and the column pairs planted: rows 0-3 get their maximum
    as an exact tie at a pair on a boundary of the fold (one thread's
    register block, two lanes, two warps, two blocks). A planted pair is
    two equal one-hot columns, a power of two at depth r, where only row
    r's h is nonzero (4.0), so every order of summation gives the same
    logit."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, d)).astype(np.float32)
    if pieces == 1:
        h = torch.from_numpy(h).bfloat16().float().numpy()
    w = (rng.standard_normal((d, c)) * 2 / np.sqrt(d)).astype(np.float32)
    w = torch.from_numpy(w).bfloat16().float().numpy()
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wcols = MMA_WARP_COLS * mt
    edge = block_columns(c, mt, grid)[0][1]     # block 1's first column
    pairs = [(1, 9), (2, 3), (wcols - 1, wcols), (edge - 2, edge + 5)]
    pairs = [(i, j) if j < c else (0, c - 1) for i, j in pairs]
    h[:, :len(pairs)] = 0.0        # depth r feeds only row r's pair
    for r, (i, j) in enumerate(pairs):
        h[r, r] = 4.0
        w[:, [i, j]] = 0.0
        bias[[i, j]] = 0.0
    for r, (i, j) in enumerate(pairs):
        target = (h[r].astype(np.float64) @ w + bias).max() + 1.5
        w[r, [i, j]] = np.float32(2.0 ** np.ceil(np.log2(target / 4.0)))
    # a pair's twin is an exact tie wherever the pair holds a row's
    # maximum; among the other columns the top two differ by > 1e-3
    twins = [j for _, j in pairs]
    rest = np.delete(h.astype(np.float64) @ w + bias, twins, axis=1)
    top2 = np.sort(rest, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3, "inputs: top-2 gap"
    return h, w, bias, pairs


# (b, d, c, mt, cluster, grid): D not a multiple of 16, C ragged against
# the tile (a block partly filled, a warp's tiles partly or wholly past
# C, padding blocks), a cluster of one
HEAD_EMU_CASES = [(8, 40, 384, 1, 2, 4), (16, 72, 640, 1, 2, 6),
                  (8, 100, 1152, 4, 2, 4), (16, 48, 512, 2, 1, 2),
                  (8, 24, 896, 2, 2, 4)]


@pytest.mark.parametrize("pieces", [3, 1])
@pytest.mark.parametrize("b,d,c,mt,cluster,grid", HEAD_EMU_CASES)
def test_head_gate_tensor_core_arithmetic_matches_jax(b, d, c, mt, cluster,
                                                      grid, pieces):
    """The tensor-core form, emulated, against the Pallas head gate in
    interpret mode (f32 hidden: three pieces; bf16 hidden: one): pred
    exact and first-index on the planted ties, conf for every supervisor
    within rtol 1e-4 / atol 1e-6."""
    h, w, bias, pairs = planted_head(b * d + c, b, d, c, mt, grid, pieces)
    ht, wt, bt = (torch.from_numpy(a) for a in (h, w, bias))
    logits = head_logits_emulated(ht, wt, bt, pieces)
    st = head_stats_emulated(logits, mt, cluster, grid)
    assert st["a1"][:4].tolist() == [i for i, _ in pairs]
    for sup in SUPERVISORS:
        want = fused_head_gate_pallas(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
            jnp.float32(jnp.inf), jnp.int32(b), supervisor=sup, k=b,
            interpret=True)
        np.testing.assert_array_equal(st["a1"].numpy(),
                                      np.asarray(want["pred"]))
        np.testing.assert_allclose(gate_conf_emulated(st, sup).numpy(),
                                   np.asarray(want["conf"]), rtol=1e-4,
                                   atol=1e-6)


def test_head_gate_per_step_sums_track_fp32():
    """The emulated split-and-step logits equal the f32 product within a
    few ulp of the logits' scale at yi-6b's depth (the steps' fp32 adds),
    and one bf16 piece alone would not."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((4096, 64)) / 64)
                         .astype(np.float32)).bfloat16().float()
    bias = torch.zeros(64)
    want = h.double() @ w.double()
    got = head_logits_emulated(h, w, bias, 3).double()
    one = head_logits_emulated(h, w, bias, 1).double()
    scale = want.abs().max()
    assert (got - want).abs().max() < 1e-5 * scale
    assert (one - want).abs().max() > 1e-3 * scale


def narrow_stats_emulated(h: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor) -> dict:
    """The narrow form (C <= 32) in f32: lane l's partial dots over depths
    l, l + 32, ... in order, the reduce-scatter (at offset o = 16 .. 1 a
    lane keeps the lower half of its columns if lane & o is 0, else the
    upper half, and adds its partner's half: keep + received), lane l's
    logit (+ bias) folded alone, the lanes merged by the shuffle tree."""
    b, d = h.shape
    c = w.shape[1]
    wp = torch.zeros(d, 32)
    wp[:, :c] = w
    p = torch.zeros(b, 32, 32)                       # [row, lane, column]
    for d0 in range(0, d, 32):
        n = min(32, d - d0)
        p[:, :n] = p[:, :n] + h[:, d0:d0 + n, None] * wp[None, d0:d0 + n]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        upper = (lanes & o) != 0
        lo, hi = p[:, :, :o], p[:, :, o:2 * o]
        give = torch.where(upper[None, :, None], lo, hi)
        keep = torch.where(upper[None, :, None], hi, lo)
        p = keep + give[:, lanes ^ o]
    x = p[:, :, 0] + torch.cat([bias, torch.zeros(32 - c)])[None]
    st = _fold(_empty((b, 32)), x[..., None], lanes[None, :, None]
               .expand(b, 32, 1), (lanes < c)[None].expand(b, 32))
    return _tree(st)


@pytest.mark.parametrize("b,d,c", [(8, 32, 8), (16, 100, 32), (8, 7, 5),
                                   (32, 300, 20)])
def test_head_gate_narrow_arithmetic_matches_jax(b, d, c):
    """The narrow form's order of sums, emulated, against the Pallas head
    gate (interpret mode): pred exact, conf within rtol 1e-4 / atol
    1e-6 for every supervisor."""
    rng = np.random.default_rng(b + d + c)
    h = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.standard_normal((d, c)) * 3 / np.sqrt(d)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    st = narrow_stats_emulated(*(torch.from_numpy(a) for a in (h, w, bias)))
    for sup in SUPERVISORS:
        want = jax_head_gate(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                             supervisor=sup, force_pallas=True,
                             interpret=True)
        np.testing.assert_array_equal(st["a1"].numpy(),
                                      np.asarray(want["pred"]))
        np.testing.assert_allclose(gate_conf_emulated(st, sup).numpy(),
                                   np.asarray(want["conf"]), rtol=1e-4,
                                   atol=1e-6)


# ------------------------------------------------------- head gate plan

@pytest.mark.parametrize("b", [1, 8, 32, 33, 100])
@pytest.mark.parametrize("d,c", [(32, 8), (8, 64), (96, 700), (4096, 8000),
                                 (4100, 8008), (100, 4104), (4096, 64000),
                                 (300, 4099), (16, 5), (4096, 32), (7, 33)])
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_head_plan_covers_every_column_once(b, d, c, w_dtype, h_dtype):
    """Narrow (C <= 32): a warp per row, lane l folding column l;
    tensor cores (bf16 w, C % 8 == 0, aligned): blocks of 128 MT
    columns, 8 warps x MT 16-column tiles, thread g folding g + 8 i; the
    FMA tile otherwise: 256 columns a block, lane l folding l + 32 i.
    Every column is folded exactly once per row, every row has a block,
    the column blocks are a multiple of the cluster and at most
    cluster - 1 of them are padding, and the scratch holds a ticket per
    row group and a partial per cluster."""
    for aligned in (True, False):
        p = head_plan(b, d, c, h_dtype, w_dtype, aligned)
        assert head_plan(b, d, c, h_dtype, w_dtype, aligned) is p
        seen = []
        if c <= NARROW_COLS:
            assert p.form == "narrow" and p.scratch == 0
            assert p.grid == b
            seen = [lane for lane in range(32) if lane < c]
        else:
            mma = w_dtype == torch.bfloat16 and c % 8 == 0 and aligned
            assert p.form == ("mma" if mma else "fma")
            assert p.mt <= (4 if h_dtype == torch.float32 else 2)
            assert 1 <= p.cluster <= HEAD_CLUSTER and p.grid % p.cluster == 0
            assert p.groups * HEAD_ROWS >= b > (p.groups - 1) * HEAD_ROWS
            assert p.grid * p.tile_cols >= c
            assert p.scratch >= p.groups + p.groups * (
                p.grid // p.cluster) * HEAD_ROWS * 6
            if p.form == "mma":
                assert p.tile_cols == MMA_WARPS * MMA_WARP_COLS * p.mt
                assert (p.grid - p.cluster) * p.tile_cols < c
                for c0, c1 in block_columns(c, p.mt, p.grid):
                    for wi in range(MMA_WARPS):
                        wc0 = c0 + wi * MMA_WARP_COLS * p.mt
                        for g in range(8):
                            seen += [wc0 + g + 8 * i for i in range(2 * p.mt)
                                     if wc0 + g + 8 * i < c1]
            else:
                assert p.tile_cols == FMA_TILE_COLS
                assert (p.grid - p.cluster) * p.tile_cols < c
                for x in range(p.grid):
                    c0 = x * p.tile_cols
                    for lane in range(32):
                        seen += [c0 + lane + 32 * i
                                 for i in range(FMA_TILE_COLS // 32)
                                 if c0 + lane + 32 * i < c]
        assert sorted(seen) == list(range(c))


def test_head_scratch_is_kept_per_ticket_region():
    """The merge scratch is reused only by plans with the same ticket
    region: a plan with nine row groups (tickets 0-15) never gets a
    buffer whose int32s 8-15 hold an earlier one-group plan's partial
    statistics, even when that buffer is large enough."""
    from repro_torch.kernels.fused_head_gate import kernel as fk
    cpu, stream = torch.device("cpu"), 12345
    bf = torch.bfloat16
    big = head_plan(32, 4096, 64000, torch.float32, bf)
    small = head_plan(288, 256, 1000, torch.float32, bf)
    assert small.scratch < big.scratch
    t_big, t_small = fk._ticket_ints(big.groups), fk._ticket_ints(small.groups)
    assert t_big < t_small
    try:
        a = fk._scratch(cpu, stream, t_big, big.scratch)
        a[t_big:] = 7                      # partials left by a kernel
        b = fk._scratch(cpu, stream, t_small, small.scratch)
        assert b.data_ptr() != a.data_ptr()
        assert int(b[:t_small].abs().sum()) == 0
        assert fk._scratch(cpu, stream, t_big, big.scratch) is a
        assert fk._scratch(cpu, stream, t_small, small.scratch) is b
    finally:
        for key in [k for k in fk._SCRATCH if k[1] == stream]:
            del fk._SCRATCH[key]

