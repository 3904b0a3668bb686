"""The generate path's two kernels in the PyTorch port — maxconf and
decode attention — as their plain PyTorch versions (what a CPU tensor
runs) against the JAX package: its Pallas kernels in interpret mode, its
jnp oracles, and both packages' ``gqa_attention`` in decode mode.

Inputs come from numpy seeds and reach both packages as the same numbers.
Tolerances: maxconf's prediction exact (ties planted and resolved to the
first index); its three floats rtol 1e-5 / atol 1e-6 (fp32 softmax sums
in another order), except the Pallas kernel's entropy, ``m1 + log s -
t/s``: a difference of terms as large as the top logit, each rounded in
f32, so it is held to atol 2e-6 * max|logit| (~1e-7 relative to the
terms). Decode attention in f32 to 1e-5
(f32 dots and softmax summed in another order). bf16 outputs of the two
oracles to 1/64 (one bf16 rounding of outputs of order 1 from f32 values
that differ by ~1e-6); the kernel oracle against ``gqa_attention`` in
bf16 to 3e-2, because JAX's ``_sdpa`` (and the port's copy of it) rounds
the probabilities to bf16 before the PV product and the kernel does not.
The CUDA maxconf's own arithmetic (the statistics pass of
``csrc/vocab_stats.cuh``, emulated in f32 as ``tests/test_torch_kernels.py``
emulates it for the gate) is held to the Pallas kernel at the card's
tolerances (``chip_smoke.py``'s ``check_maxconf``): prediction exact,
max_softmax and pcs atol 1e-5, entropy atol 2e-6 * max|logit| + 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import decode_attn as jax_decode_attn  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.maxconf.ops import maxconf as jax_maxconf  # noqa: E402
from repro.kernels.maxconf.ref import maxconf_ref as jax_maxconf_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import decode_attn, launch_counts  # noqa: E402
from repro_torch.kernels.maxconf.ops import maxconf  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    KEY_TILE, SM_COUNT, SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED, splits)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.maxconf.ref import maxconf_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from tests.test_torch_kernels import (STATS_CASES, VEC,  # noqa: E402
                                      stats_emulated, tied_logits)

MAXCONF_KEYS = ("max_softmax", "pcs", "entropy")


def bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values that bf16 represents exactly."""
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def logits_with_ties(seed: int, b: int, v: int, scale: float = 4.0):
    """Normal logits; row r gets its maximum planted twice (at two random
    columns, one past the first 2048-column block when V allows), so the
    first index must win."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, v)) * scale).astype(np.float32)
    for r in range(b):
        if r % 2:
            continue
        c1 = int(rng.integers(0, min(v, 2048)))
        c2 = int(rng.integers(c1 + 1, v)) if c1 + 1 < v else c1
        x[r, [c1, c2]] = x[r].max() + 1.0
    return x


# ------------------------------------------------------------------ maxconf

def check_maxconf(got: dict, want: dict, ent_atol: float = 1e-6) -> None:
    np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                  np.asarray(want["prediction"]))
    for k in MAXCONF_KEYS:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
            atol=ent_atol if k == "entropy" else 1e-6, err_msg=k)


@pytest.mark.parametrize("b,v", [(1, 5000), (3, 1000), (8, 2048),
                                 (5, 4100), (13, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxconf_ref_matches_jax_pallas_and_oracle(b, v, dtype):
    x = logits_with_ties(b * 1000 + v, b, v)
    if dtype == "bfloat16":
        x = bf16_exact(x)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = {k: a.numpy() for k, a in maxconf_ref(tx).items()}
    assert got["prediction"].dtype == np.int32
    check_maxconf(got, jax_maxconf(jx, force_pallas=True, interpret=True),
                  ent_atol=2e-6 * float(np.abs(x).max()))
    check_maxconf(got, jax_maxconf_ref(jx))
    # the planted ties resolve to the first index
    first = np.argmax(x == x.max(1, keepdims=True), axis=1)
    np.testing.assert_array_equal(got["prediction"], first)


def test_maxconf_extreme_logits():
    x = np.zeros((2, 128), np.float32)
    x[0, :3] = [1e4, -1e4, 0.0]
    x[1, 5] = x[1, 77] = -1e4              # a row of ties at 0
    got = {k: a.numpy() for k, a in maxconf_ref(torch.from_numpy(x)).items()}
    check_maxconf(got, jax_maxconf(jnp.asarray(x), force_pallas=True,
                                   interpret=True), ent_atol=2e-6 * 1e4)
    assert np.isfinite(got["max_softmax"]).all()
    np.testing.assert_allclose(got["max_softmax"][0], 1.0, atol=1e-6)
    assert got["prediction"].tolist() == [0, 0]


def maxconf_emulated(x: np.ndarray, vec: int, cluster: int,
                     head: int) -> dict:
    """maxconf.cu's outputs from the emulated statistics pass: the
    epilogue of vstats::epilogue."""
    st = stats_emulated(torch.from_numpy(x), vec, cluster, head)
    z = st["s"]
    return {"prediction": st["a1"].numpy(), "max_softmax": (1.0 / z).numpy(),
            "pcs": ((1.0 - torch.exp(st["m2"] - st["m1"])) / z).numpy(),
            "entropy": (st["m1"] + torch.log(z) - st["t"] / z).numpy()}


def check_maxconf_kernel_tols(got: dict, want: dict, x: np.ndarray) -> None:
    np.testing.assert_array_equal(got["prediction"],
                                  np.asarray(want["prediction"]))
    tols = {"max_softmax": 1e-5, "pcs": 1e-5,
            "entropy": 2e-6 * float(np.abs(x).max()) + 1e-5}
    for k, tol in tols.items():
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("b,c,dtype,cluster,head", STATS_CASES)
def test_maxconf_kernel_arithmetic_matches_jax(b, c, dtype, cluster, head):
    """The CUDA maxconf's fold order and merges, emulated in f32, against
    the JAX Pallas kernel (interpret mode): every planted tie (across a
    cluster rank, inside and across register blocks, first and last
    column) resolves to the first index, and a maximum found twice gives
    pcs 0."""
    x = tied_logits(b + c, b, c, VEC[dtype], cluster, head, dtype)
    got = maxconf_emulated(x, VEC[dtype], cluster, head)
    want = jax_maxconf(jnp.asarray(x, jnp.dtype(dtype)), force_pallas=True,
                       interpret=True)
    check_maxconf_kernel_tols(got, want, x)
    np.testing.assert_array_equal(got["prediction"], np.argmax(x, 1))
    tied = (x == x.max(1, keepdims=True)).sum(1) > 1
    assert tied.any() or c == 1
    assert (got["pcs"][tied] == 0).all()
    assert (np.asarray(want["pcs"])[tied] == 0).all()


@pytest.mark.parametrize("cluster,head", [(0, 0), (0, 3), (3, 1), (8, 0)])
def test_maxconf_kernel_arithmetic_on_extreme_logits(cluster, head):
    x = np.zeros((2, 4100), np.float32)
    x[0, :3] = [1e4, -1e4, 0.0]
    x[1, 5] = x[1, 77] = -1e4              # a row of ties at 0
    got = maxconf_emulated(x, 4, cluster, head)
    check_maxconf_kernel_tols(got, jax_maxconf(jnp.asarray(x),
                                               force_pallas=True,
                                               interpret=True), x)
    assert np.isfinite(got["max_softmax"]).all()
    assert got["prediction"].tolist() == [0, 0]


def test_maxconf_on_cpu_runs_the_plain_version_uncounted():
    x = torch.from_numpy(logits_with_ties(3, 4, 700))
    before = launch_counts()["maxconf"]
    got = maxconf(x)
    want = maxconf_ref(x)
    assert launch_counts()["maxconf"] == before
    for k, a in want.items():
        assert torch.equal(got[k], a), k


# --------------------------------------------------------- decode attention

def decode_inputs(seed, b, s, h, kh, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    if dtype != np.float32:
        q, k, v = bf16_exact(q), bf16_exact(k), bf16_exact(v)
    return q, k, v


def to_torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,h,kh,hd,kv_len", [
    (3, 8, 2, 64, (1, 300, 512)),
    (2, 4, 4, 128, (512, 17)),
    (1, 16, 1, 64, (200,)),
    (2, 32, 8, 80, (512, 37)),       # hd 80 (h2o-danube-1.8b)
    (2, 14, 2, 128, (300, 512)),     # a group of 7 (qwen2-7b)
    (1, 7, 1, 80, (129,)),           # G = 7 at hd 80
    (2, 8, 8, 112, (512, 37)),       # hd 112, MHA (zamba2-7b)
    (2, 16, 4, 112, (300, 512)),     # hd 112, group of 4
])
def test_decode_ref_matches_jax_pallas_and_oracle(b, h, kh, hd, kv_len):
    s = 512                                # the Pallas kernel's S % 512
    q, k, v = decode_inputs(sum(kv_len), b, s, h, kh, hd)
    lens = np.asarray(kv_len, np.int32)
    got = decode_attention_ref(*to_torch(q, k, v),
                               torch.from_numpy(lens)).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(lens))
    np.testing.assert_allclose(
        got, np.asarray(jax_decode_attn(*jargs, force_pallas=True,
                                        interpret=True)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*jargs)),
                               atol=1e-5)


@pytest.mark.parametrize("s,kv_len", [(77, (1, 77, 40)), (544, (544, 3, 300)),
                                      (64, (64, 64, 1))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_jax_oracle_at_any_length(s, kv_len, dtype):
    b, h, kh, hd = 3, 8, 2, 64
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = decode_inputs(s, b, s, h, kh, hd, np_dt)
    lens = np.asarray(kv_len, np.int32)
    tdt = getattr(torch, dtype)
    got = decode_attention_ref(*to_torch(q, k, v, dtype=tdt),
                               torch.from_numpy(lens))
    assert got.dtype == tdt and got.shape == (b, h, hd)
    jdt = jnp.dtype(dtype)
    want = jax_decode_ref(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                          jnp.asarray(v, jdt), jnp.asarray(lens))
    atol = 1e-5 if dtype == "float32" else 1 / 64
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("pos", [0, 37, 127])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_gqa_attention_in_decode_mode(pos, dtype):
    """One query at absolute position ``pos`` over a cache whose first
    ``pos + 1`` slots are valid: the kernel oracle against both packages'
    ``gqa_attention(q_offset=pos, kv_len_valid=pos + 1)``."""
    b, s, h, kh, hd = 2, 128, 8, 2, 64
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = decode_inputs(pos, b, s, h, kh, hd, np_dt)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tq, tk, tv = to_torch(q, k, v, dtype=tdt)
    got = decode_attention_ref(tq, tk, tv,
                               torch.full((b,), pos + 1, dtype=torch.int32))
    port_gqa = layers.gqa_attention(tq[:, None], tk, tv, causal=False,
                                    q_offset=pos, kv_len_valid=pos + 1)[:, 0]
    jax_gqa = jlayers.gqa_attention(
        jnp.asarray(q, jdt)[:, None], jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), causal=False, q_offset=jnp.int32(pos),
        kv_len_valid=jnp.int32(pos + 1))[:, 0]
    jax_gqa = np.asarray(jax_gqa, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), jax_gqa, atol=1e-5)
        np.testing.assert_allclose(port_gqa.numpy(), jax_gqa, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), jax_gqa, atol=3e-2)
        np.testing.assert_allclose(port_gqa.float().numpy(), jax_gqa,
                                   atol=1 / 64)


def test_decode_attn_on_cpu_runs_the_plain_version_uncounted():
    q, k, v = to_torch(*decode_inputs(5, 2, 40, 4, 2, 64))
    lens = torch.tensor([40, 9], dtype=torch.int32)
    before = launch_counts()["decode_attention"]
    assert torch.equal(decode_attn(q, k, v, lens),
                       decode_attention_ref(q, k, v, lens))
    assert launch_counts()["decode_attention"] == before


@pytest.mark.parametrize("b,kh,s", [(8, 4, 544), (8, 4, 16384), (1, 1, 7),
                                    (2, 8, 97), (64, 8, 4096)])
def test_decode_splits_cover_the_cache_in_whole_tiles(b, kh, s):
    p = splits(b, kh, s, 8, 128, 2)
    assert p.chunk % KEY_TILE == 0 and p.chunk >= 2 * KEY_TILE
    assert p.nsplit * p.chunk >= s > (p.nsplit - 1) * p.chunk


@pytest.mark.parametrize("b,kh,s,g,hd,esz", [
    (8, 4, 544, 8, 128, 2),       # the generate path's last step
    (8, 4, 16384, 8, 128, 2),     # a long context
    (8, 4, 544, 8, 128, 4),       # f32
    (2, 1, 100, 16, 64, 2),
    (2, 1, 300, 16, 128, 4),      # the largest shared memory
    (3, 2, 77, 3, 64, 4),         # G = 3, padded to 4
    (1, 1, 7, 1, 64, 2),
    (8, 8, 544, 4, 80, 2),        # h2o-danube-1.8b's generate, hd 80
    (1, 8, 4096, 4, 80, 2),       # its 4096-slot ring at B = 1
    (3, 2, 77, 7, 80, 4),         # f32 at hd 80, G = 7
    (8, 4, 544, 7, 128, 2),       # qwen2-7b's group of 7
    (8, 32, 544, 1, 112, 2),      # zamba2-7b's generate: hd 112, MHA
    (8, 32, 544, 1, 112, 4),      # f32
    (2, 4, 300, 4, 112, 2),       # hd 112, group of 4
])
def test_decode_plan_keeps_bytes_in_flight(b, kh, s, g, hd, esz):
    """The ring holds >= 3 tiles, the shared memory fits a block, the SM's
    resident blocks keep >= 50 KB in flight (twice 3.35 TB/s x ~1 us
    over 132 SMs), and the grid is one wave of resident blocks."""
    p = splits(b, kh, s, g, hd, esz)
    assert p.stages >= 3
    assert p.group_pad >= g and p.group_pad & (p.group_pad - 1) == 0
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert p.resident * (p.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM
    assert p.inflight_bytes >= 50_000
    assert p.nsplit == 1 or p.nsplit * b * kh <= SM_COUNT * p.resident
    assert p.chunk % KEY_TILE == 0
    assert p.nsplit * p.chunk >= s > (p.nsplit - 1) * p.chunk
    assert splits(b, kh, s, g, hd, esz) is p      # cached per shape
