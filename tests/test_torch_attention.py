"""Prefill attention of the PyTorch port against the JAX package.

On the CPU the port's ``attention`` runs its plain PyTorch version; the JAX
side runs its Pallas flash-attention kernel in interpret mode, and both
packages' plain ``gqa_attention`` (what JAX's prefill calls) are compared
too. Inputs come from numpy seeds.

Tolerances: f32 is held to 1e-5 (the same f32 products summed in another
order over at most 96 keys); bf16 to 2e-2 (one bf16 rounding of outputs of
order 1 is ~4e-3, and JAX's ``gqa_attention`` also rounds the
probabilities to bf16 before the PV product).
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import attention as jax_attention  # noqa: E402
from repro.models.layers import gqa_attention as jax_gqa  # noqa: E402
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
