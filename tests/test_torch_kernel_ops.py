"""The kernels' ops and the plain prefill attention, on the CPU.

Flash prefill, decode attention and the RWKV6 scan are each an op,
``torch.ops.repro_torch.*``: its CUDA implementation is the kernel's
launch, and its fake implementation is what the dry-run's fake tensors
run (each wrapper hands a fake tensor to the op, never to the plain
version; ``analysis.roofline.OpTally`` counts the op by a formula kept
beside it). Here, on seeded inputs:

* the fake implementation's output has the plain version's shape, dtype
  and strides (and the scan's state the plain version's), and the
  wrapper reaches neither the plain version nor a launch count;
* the op's formula credits the plain version's dot FLOPs exactly, and
  decode attention's count holds the launch's scratch while it runs;
* ``attention_ref``, the plain prefill (fp32 logits a chunk of query
  rows at a time, a masked fill, ``torch.softmax``, the PV product), is
  JAX's ``gqa_attention``: within 1e-5 in fp32 (the same products
  summed in another order over at most 192 keys), 2e-2 in bf16 (JAX
  rounds the probabilities to bf16 before PV, the port keeps fp32: one
  bf16 rounding of outputs of order 1 is ~4e-3).
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import gqa_attention as jax_gqa  # noqa: E402
from repro_torch.analysis.roofline import OpTally  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro_torch.launch.sharding import fake_mode  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _inputs(name: str, dtype, seed: int = 0) -> dict:
    """Seeded CPU inputs of each kernel, at its serving path's layout:
    flash [B, T, H, hd] over [B, S, K, hd] (a group of 4, hd 80); decode
    one token over a 96-slot cache; the scan 12 steps of 2 heads of 64
    (r, k, v in ``dtype``, w, u and the state fp32)."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dt)
    if name == "flash":
        return {"q": t(2, 48, 8, 80), "k": t(2, 48, 2, 80),
                "v": t(2, 48, 2, 80)}
    if name == "decode":
        return {"q": t(2, 8, 64), "k_cache": t(2, 96, 2, 64),
                "v_cache": t(2, 96, 2, 64),
                "kv_len": torch.tensor([37, 96], dtype=torch.int32)}
    return {"r": t(2, 12, 2, 64), "k": t(2, 12, 2, 64), "v": t(2, 12, 2, 64),
            "w": torch.rand(2, 12, 2, 64, generator=torch.Generator()
                            .manual_seed(seed)) * 0.5 + 0.45,
            "u": t(2, 64, dt=torch.float32),
            "s0": t(2, 2, 64, 64, dt=torch.float32)}


WRAPPERS = {"flash": (flash_ops.attention, attention_ref),
            "decode": (decode_ops.decode_attn, decode_attention_ref),
            "scan": (scan_ops.rwkv6_scan, rwkv6_scan_ref)}
REFS = {"flash": (flash_ops, "attention_ref"),
        "decode": (decode_ops, "decode_attention_ref"),
        "scan": (scan_ops, "rwkv6_scan_ref")}


def _meta(x) -> list:
    return [(tuple(t.shape), t.dtype, t.stride())
            for t in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_fake_op_has_the_plain_versions_output_metadata(name, dtype,
                                                         monkeypatch):
    wrapper, ref = WRAPPERS[name]
    args = _inputs(name, dtype)
    want = ref(**args)
    before = launch_counts()
    mode = fake_mode()
    fakes = {k: mode.from_tensor(v) for k, v in args.items()}

    def refuse(*a, **k):
        raise AssertionError("a fake tensor reached the plain version")
    monkeypatch.setattr(*REFS[name], refuse)
    with mode:
        got = wrapper(**fakes)
    assert _meta(got) == _meta(want)
    assert launch_counts() == before
    if name == "scan":      # the state written in place, as on the card
        with mode:
            s = fakes["s0"]
            y, s_t = wrapper(**{**fakes, "s_out": s})
        assert s_t is s and _meta(y) == _meta(want[0])


def _count(fn, args: dict) -> OpTally:
    mode = fake_mode()
    fakes = {k: mode.from_tensor(v) for k, v in args.items()}
    tally = OpTally()
    with mode, tally:
        fn(**fakes)
    return tally


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_op_formula_credits_the_plain_versions_dot_flops(name, dtype):
    wrapper, ref = WRAPPERS[name]
    args = _inputs(name, dtype)
    op, plain = _count(wrapper, args), _count(ref, args)
    assert op.total_dot_flops == plain.total_dot_flops > 0
    assert op.peak_bytes < plain.peak_bytes


def test_decode_op_holds_its_scratch():
    """The decode kernel's launch allocates its splits' partials beside
    its output: the count holds both while the op runs."""
    args = _inputs("decode", torch.bfloat16)
    q, k = args["q"], args["k_cache"]
    b, h, hd = q.shape
    p = decode_kernel.splits(b, k.shape[2], k.shape[1], h // k.shape[2], hd,
                             q.element_size())
    scratch = 4 * decode_kernel.scratch_numel(b, h, hd, p.nsplit)
    tally = _count(decode_ops.decode_attn, args)
    assert scratch > 0
    assert tally.peak_bytes == q.numel() * q.element_size() + scratch


ATTN_CASES = [  # (b, t, h, kh, hd, causal, window, q_chunk)
    (2, 64, 4, 4, 64, True, 0, 16),       # four query chunks
    (1, 192, 8, 2, 80, True, 48, 64),     # GQA, hd 80, a window
    (1, 64, 14, 2, 128, False, 0, 1024),  # a group of 7, non-causal
]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (ml_dtypes.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,kh,hd,causal,window,q_chunk", ATTN_CASES)
def test_attention_ref_is_jax_gqa_attention(b, t, h, kh, hd, causal, window,
                                            q_chunk, dtype, tol):
    rng = np.random.default_rng(t + h)
    q, k, v = (rng.standard_normal(s).astype(np.float32).astype(dtype)
               for s in ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
    want = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, q_offset=0, window=window)
    got = attention_ref(*(params_from_jax(x, "cpu") for x in (q, k, v)),
                        causal=causal, window=window, q_chunk=q_chunk)
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), atol=tol)
