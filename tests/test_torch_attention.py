"""Prefill attention of the PyTorch port against the JAX package.

On the CPU the port's ``attention`` runs its plain PyTorch version; the JAX
side runs its Pallas flash-attention kernel in interpret mode, and both
packages' plain ``gqa_attention`` (what JAX's prefill calls) are compared
too. Inputs come from numpy seeds.

Tolerances: f32 is held to 1e-5 (the same f32 products summed in another
order over at most 96 keys); bf16 to 2e-2 (one bf16 rounding of outputs of
order 1 is ~4e-3, and JAX's ``gqa_attention`` also rounds the
probabilities to bf16 before the PV product).

The CUDA kernel runs only on the card; here its launch plan is checked,
and a model of its bf16 numerics (64-key tiles, online softmax in fp32, P
rounded to bf16 before P V, fp32 accumulation) is held to JAX at the
same 2e-2 that the kernel is held to on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import attention as jax_attention  # noqa: E402
from repro.models.layers import gqa_attention as jax_gqa  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    MAX_SMEM_PER_BLOCK, plan)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.models.layers import gqa_attention  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


def t_(a):
    """numpy (incl. ml_dtypes bfloat16) -> CPU torch tensor."""
    return params_from_jax(np.asarray(a), "cpu")


ATTN_CASES = [  # (b, t, h, kh, hd, causal, window)
    (2, 64, 4, 4, 64, True, 0),
    (1, 96, 8, 2, 64, True, 0),       # GQA, group of 4
    (2, 64, 8, 1, 128, True, 32),     # sliding window, MQA
    (1, 64, 4, 2, 64, False, 0),      # non-causal
    (1, 64, 8, 2, 80, True, 0),       # hd 80 (h2o-danube-1.8b), group of 4
    (2, 64, 4, 4, 80, True, 32),      # hd 80, sliding window
    (1, 64, 14, 2, 64, True, 0),      # a group of 7 (qwen2-7b)
    (1, 64, 4, 4, 112, True, 0),      # hd 112, MHA (zamba2-7b's shared block)
    (2, 64, 8, 2, 112, True, 0),      # hd 112, group of 4
]


def qkv(seed, b, t, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("b,t,h,kh,hd,causal,window", ATTN_CASES)
def test_flash_ref_matches_jax_pallas_f32(b, t, h, kh, hd, causal, window):
    q, k, v = qkv(t + h, b, t, h, kh, hd)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, qb=32, kb=32,
                         force_pallas=True, interpret=True)
    got = attention(t_(q), t_(k), t_(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("b,t,h,kh,hd,causal,window", ATTN_CASES)
def test_flash_ref_matches_gqa_attention(b, t, h, kh, hd, causal, window):
    """The port's prefill attention (ref on the CPU) against the plain
    ``gqa_attention`` of both packages (the function JAX's prefill runs)."""
    q, k, v = qkv(t + kh, b, t, h, kh, hd)
    got = attention(t_(q), t_(k), t_(v), causal=causal, window=window)
    mine = gqa_attention(t_(q), t_(k), t_(v), causal=causal, q_offset=0,
                         window=window)
    jax_out = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, q_offset=0, window=window)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), atol=1e-5)
    np.testing.assert_allclose(mine.numpy(), np.asarray(jax_out), atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_bf16_matches_jax(window):
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in qkv(7, 2, 64, 8, 2, 64))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, qb=32, kb=32,
                         force_pallas=True, interpret=True)
    got = attention(t_(q), t_(k), t_(v), causal=True, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), atol=2e-2)
    mine = gqa_attention(t_(q), t_(k), t_(v), causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), mine.float().numpy(),
                               atol=2e-2)


def tiled_bf16_model(q, k, v, *, causal, window, keys=64):
    """What the bf16 tensor-core kernel computes, in fp32 on the CPU: q, k
    and v in bf16 [B, T, H, hd] / [B, S, K, hd]; scores in fp32, the
    online softmax over tiles of ``keys`` keys (running max and fp32 sum
    per row), each tile's P rounded to bf16 before P V, fp32 output
    accumulator, divided by the sum, rounded to bf16."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, t, kh, h // kh, hd)
    kf, vf = k.float(), v.float()
    qpos = torch.arange(t)[:, None]
    m = torch.full((b, kh, h // kh, t, 1), -float("inf"))
    den = torch.zeros_like(m)
    acc = torch.zeros(b, kh, h // kh, t, hd)
    for s0 in range(0, s, keys):
        kpos = torch.arange(s0, min(s, s0 + keys))[None, :]
        sc = torch.einsum("btkgh,bskh->bkgts", qf,
                          kf[:, s0:s0 + keys]) / np.sqrt(hd)
        ok = torch.ones(t, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        sc = sc.masked_fill(~ok, -float("inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(sc - m_use)
        alpha = torch.exp(m - m_use)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgts,bskh->bkgth", p.bfloat16().float(), vf[:, s0:s0 + keys])
        m = m_new
    out = acc / den
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).bfloat16()


@pytest.mark.parametrize("b,t,h,kh,hd,causal,window", ATTN_CASES)
def test_bf16_kernel_numerics_match_jax(b, t, h, kh, hd, causal, window):
    """Rounding P to bf16 before P V (the tensor-core kernel's one new
    rounding) keeps the output within the bf16 limit of JAX's Pallas
    kernel and ``gqa_attention``, and of the port's plain version."""
    q, k, v = (a.astype(ml_dtypes.bfloat16)
               for a in qkv(t * h + kh, b, t, h, kh, hd))
    got = tiled_bf16_model(t_(q), t_(k), t_(v), causal=causal,
                           window=window).float().numpy()
    pallas = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, qb=32, kb=32,
                           force_pallas=True, interpret=True)
    oracle = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_offset=0, window=window)
    plain = attention(t_(q), t_(k), t_(v), causal=causal, window=window)
    for want in (pallas, oracle, plain.float()):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=2e-2)


@pytest.mark.parametrize("b,t,kh,g,hd,dtype", [
    (8, 48, 4, 8, 128, torch.bfloat16),     # a serve window of yi-6b
    (8, 512, 4, 8, 128, torch.bfloat16),    # the generate prefill
    (1, 2048, 4, 8, 128, torch.bfloat16),   # a long prompt
    (1, 1, 4, 8, 128, torch.bfloat16),      # T = 1
    (2, 77, 4, 3, 64, torch.bfloat16),      # ragged rows, hd 64
    (10, 48, 4, 8, 128, torch.float32),
    (1, 130, 2, 4, 64, torch.float32),
    (8, 512, 8, 4, 80, torch.bfloat16),     # h2o-danube-1.8b, hd 80
    (1, 4608, 8, 4, 80, torch.bfloat16),    # past its window of 4096
    (2, 77, 2, 7, 80, torch.float32),
    (8, 48, 4, 7, 128, torch.bfloat16),     # qwen2-7b's group of 7
    (8, 48, 32, 1, 112, torch.bfloat16),    # zamba2-7b: hd 112, MHA
    (8, 512, 32, 1, 112, torch.bfloat16),   # its generate prefill
    (8, 48, 32, 1, 112, torch.float32),
    (2, 77, 8, 4, 112, torch.bfloat16),     # hd 112, group of 4
])
def test_flash_plan_covers_the_rows_within_shared_memory(b, t, kh, g, hd,
                                                         dtype):
    p = plan(b, t, kh, g, hd, dtype)
    assert p.grid[1] == b * kh
    assert p.grid[0] * p.rows >= t * g > (p.grid[0] - 1) * p.rows
    assert p.smem_bytes <= MAX_SMEM_PER_BLOCK
    if dtype == torch.bfloat16:     # wgmma: one warpgroup, 64 rows
        assert p.tensor_cores and p.stages >= 2
        assert p.threads == 128 and p.rows == 64 and p.keys % 16 == 0
    else:                           # the CUDA-core kernel, static memory
        assert not p.tensor_cores and p.smem_bytes <= 48 * 1024
    assert plan(b, t, kh, g, hd, dtype) is p      # cached per shape
