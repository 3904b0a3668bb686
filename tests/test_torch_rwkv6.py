"""RWKV6 in the PyTorch port against the JAX package: the scan's plain
version (what a CPU tensor runs) against JAX's oracle and its Pallas
kernel in interpret mode, ``group_norm``, ``time_mix``, ``channel_mix``,
and the reduced rwkv6 model's ``forward``, ``prefill``, ``decode_step``,
``greedy_generate`` and the serving slice with rwkv6 as the remote tier.
Weights come from JAX's initialisers through ``params_from_jax``, inputs
from numpy seeds; the port runs on the CPU.

Tolerances: the scan in f32 to rtol/atol 1e-5 against JAX's oracle (the
same per-token recurrence; the einsum sums M = 16..64 products in another
order) and 2e-3 against the Pallas kernel (the JAX package's own
tolerance for that kernel against the oracle, tests/test_kernels.py);
state carry 1e-5; group_norm 1e-6 (a few f32 roundings). The reduced
model (2 layers, d_model 256, fp32): logits, token-shift states and
layer outputs to 1e-4 (f32 matmuls of width 256-512 and the
recurrence summed in another order, as for the dense family); the wkv
state, whose entries sum up to T outer products, to rtol 1e-4 / atol
1e-4. Generated tokens exact, after asserting that every step's top-2
logit gap exceeds 1e-4; likelihoods 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import make_classification_task  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_time_mix_scan  # noqa: E402
from repro.kernels.rwkv6_scan.ref import \
    rwkv6_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import surrogate as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving.engine import BILLING_FIELDS  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.supervisors import max_softmax  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as rk  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import rwkv6 as rwkv  # noqa: E402
from repro_torch.models import surrogate as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import Request, ServeConfig  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.serving.generate import graft  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "rwkv6-1.6b"
GAP = 1e-4
STATE_KEYS = ("wkv", "tm_prev", "cm_prev")


def scan_inputs(seed, b, t, h, m):
    """r, k, v, u at scale 0.5, w = sigmoid(normal) in (0, 1), s0 normal
    (a carried state, not zeros), all f32 numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = (0.5 * n(b, t, h, m) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-n(b, t, h, m)))).astype(np.float32)
    u = 0.5 * n(h, m)
    s0 = 0.5 * n(b, h, m, m)
    return r, k, v, w, u, s0


def torch_args(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return dict(jcfg=jcfg, jp=jp, cfg=get_config(ARCH).reduced(), tp=tp)


def close_state(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["wkv"].numpy(), np.asarray(want["wkv"]),
                               rtol=1e-4, atol=1e-4, err_msg="wkv")
    for key in ("tm_prev", "cm_prev"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


# --------------------------------------------------------------- the scan

SCAN_SHAPES = [(128, 2, 32), (256, 4, 64), (64, 1, 16), (1, 4, 64),
               (100, 2, 64)]


@pytest.mark.parametrize("t,h,m", SCAN_SHAPES)
def test_scan_ref_matches_jax_oracle(t, h, m):
    arrs = scan_inputs(t + h + m, 2, t, h, m)
    y, s = rwkv6_scan_ref(*torch_args(arrs))
    jy, js = jax_scan_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t,h,m", SCAN_SHAPES)
def test_scan_ref_matches_pallas_kernel(t, h, m):
    arrs = scan_inputs(7 * t + m, 2, t, h, m)
    y, s = rwkv6_scan_ref(*torch_args(arrs))
    jy, js = rwkv6_time_mix_scan(*map(jnp.asarray, arrs), force_pallas=True,
                                 interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-3,
                               atol=2e-3)


def test_scan_matches_time_mix_core():
    """The JAX model's own recurrence (``_time_mix_core``), with r/k/v in
    bf16 as the full-width model passes them."""
    arrs = scan_inputs(3, 2, 48, 4, 64)
    bf = [torch.from_numpy(a).bfloat16() for a in arrs[:3]]
    y, s = rwkv6_scan_ref(*bf, *torch_args(arrs[3:]))
    jbf = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs[:3]]
    jy, js = jrwkv._time_mix_core(None, None, *jbf,
                                  *map(jnp.asarray, arrs[3:]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_scan_state_carry():
    """Two halves with the state carried == the whole (mirrors
    tests/test_kernels.py::test_rwkv6_scan_state_carry), here through
    ``ops.rwkv6_scan`` updating the state in place."""
    r, k, v, w, u, s0 = torch_args(scan_inputs(11, 1, 64, 2, 16))
    y_full, s_full = rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    y1, s1 = rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u,
                        state, state)
    assert s1 is state
    y2, s2 = rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u,
                        state, state)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), atol=1e-5)


# The CUDA kernel's summation order (csrc/rwkv6_scan.cu), emulated on the
# CPU in fp32: the state cut into 8 row groups of M/8 rows; each group's
# partial of y_t[j] is one chain over its rows of r_i S_ij, plus v_j times
# the group's chain of (r_i u_i) k_i; the 8 partials are reduced as the
# kernel's xor-4, xor-2, xor-1 shuffles do, ((p0 + p4) + (p2 + p6)) +
# ((p1 + p5) + (p3 + p7)).

def scan_kernel_order(r, k, v, w, u, s0, groups=rk.ROW_GROUPS):
    b, t, h, m = r.shape
    a = m // groups
    s = s0.clone().view(b, h, groups, a, m)
    ug = u.view(h, groups, a)
    ys = []
    for tt in range(t):
        rt, kt, wt = (z[:, tt].view(b, h, groups, a) for z in (r, k, w))
        vj = v[:, tt]                                      # [B, H, M]
        bq = torch.zeros(b, h, groups)
        p = torch.zeros(b, h, groups, m)
        for ii in range(a):
            bq = bq + rt[..., ii] * ug[..., ii] * kt[..., ii]
            p = p + rt[..., ii, None] * s[..., ii, :]
        p = p + vj[:, :, None, :] * bq[..., None]
        lvl1 = [p[:, :, g] + p[:, :, g + 4] for g in range(4)]
        ys.append((lvl1[0] + lvl1[2]) + (lvl1[1] + lvl1[3]))
        s = wt[..., None] * s + kt[..., None] * vj[:, :, None, None, :]
    return torch.stack(ys, 1), s.view(b, h, m, m)


@pytest.mark.parametrize("b,t,h,m", [(2, 70, 3, 64), (2, 70, 3, 32),
                                     (1, 40, 2, 16), (3, 1, 2, 64)])
def test_scan_kernel_summation_order_matches_jax(b, t, h, m):
    """The kernel's order of sums against JAX's oracle within the chip
    check's RWKV_TOL: |err| <= 2e-5 max|want| + 1e-5, for y and s_T,
    with the decay spread as the full-width check draws it."""
    rng = np.random.default_rng(b + t + m)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    r, k, v = (0.5 * n(b, t, h, m) for _ in range(3))
    w = np.exp(-np.exp(n(b, t, h, m) - 3.0)).astype(np.float32)
    arrs = (r, k, v, w, 0.5 * n(h, m), 0.5 * n(b, h, m, m))
    got = scan_kernel_order(*torch_args(arrs))
    want = jax_scan_ref(*map(jnp.asarray, arrs))
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert np.abs(g.numpy() - x).max() <= 2e-5 * np.abs(x).max() + 1e-5


def test_scan_plan_is_cached_per_shape():
    p = rk.plan(8, 1, 32, 64, torch.bfloat16)
    assert rk.plan(8, 1, 32, 64, torch.bfloat16) is p
    assert p.args == (rk.DTYPE_CODES[torch.bfloat16], 8, 1, 32, 64)
    assert p.u_shape == (32, 64) and p.s_shape == (8, 32, 64, 64)
    assert rk.plan(8, 512, 32, 64, torch.float32).args[0] == \
        rk.DTYPE_CODES[torch.float32]
    with pytest.raises(ValueError, match="head size"):
        rk.plan(8, 1, 16, 128, torch.float32)
    with pytest.raises(ValueError, match="T >= 1"):
        rk.plan(8, 0, 32, 64, torch.float32)


# ------------------------------------------------------------ the layers

def test_group_norm_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 256)).astype(
        np.float32) * 3 + 1
    w = np.random.default_rng(3).standard_normal(256).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    got = layers.group_norm(*torch_args([x, w, b]), 4, 1e-5)
    want = jlayers.group_norm(*map(jnp.asarray, [x, w, b]), 4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _layer0(model):
    jlp = jax.tree.map(lambda a: a[0], model["jp"]["blocks"])
    tlp = tree_map(lambda a: a[0], model["tp"]["blocks"])
    return jlp, tlp


def test_time_mix_matches_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    jlp, tlp = _layer0(model)
    rng = np.random.default_rng(5)
    h = cfg.d_model // cfg.rwkv_head_dim
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((2, h, 64, 64))).astype(np.float32)
    xp = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, s_t, last = rwkv.time_mix(cfg, tlp, *torch_args([x, s0, xp]))
    jout, js, jlast = jrwkv.time_mix(jcfg, jlp, *map(jnp.asarray,
                                                     [x, s0, xp]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-6)


def test_channel_mix_matches_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    jlp, tlp = _layer0(model)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, last = rwkv.channel_mix(cfg, tlp, *torch_args([x, xp]))
    jout, jlast = jrwkv.channel_mix(jcfg, jlp, *map(jnp.asarray, [x, xp]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-6)


# ------------------------------------------------------------- the model

def test_init_params_layout_matches_jax(model):
    tp = T.init_params(model["cfg"], torch.Generator().manual_seed(0))
    shapes = tree_map(lambda a: tuple(a.shape), tp)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), model["jp"])
    assert shapes == tree_map(lambda a: tuple(a.shape), model["tp"])
    assert set(tp["blocks"]["maa_lora"]) == set(rwkv.MIX_NAMES)


def test_params_from_jax_carries_the_rwkv6_tree_bit_for_bit():
    """bf16 leaves of the nested ``maa``, ``maa_lora`` and ``decay_lora``
    dicts arrive with the same keys, shapes and bits."""
    import dataclasses

    import ml_dtypes
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                              dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jT.init_params(cfg, jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, "cpu")
    jb, tb = jp["blocks"], tp["blocks"]
    assert set(tb) == set(jb)
    assert set(tb["maa_lora"]) == set(jb["maa_lora"]) == set(rwkv.MIX_NAMES)
    for want, got in ((jb["maa_lora"]["g"]["b"]["w"],
                       tb["maa_lora"]["g"]["b"]["w"]),
                      (jb["decay_lora"]["a"]["w"], tb["decay_lora"]["a"]["w"]),
                      (jb["maa"]["w"], tb["maa"]["w"])):
        assert want.dtype == ml_dtypes.bfloat16
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


def test_forward_matches_jax(model):
    toks = np.random.default_rng(7).integers(
        1, model["cfg"].vocab_size, (2, 40)).astype(np.int32)
    with torch.no_grad():
        tx, aux = T.forward(model["cfg"], model["tp"], {"tokens": toks})
    jx, _ = jT.forward(model["jcfg"], model["jp"],
                       {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    assert float(aux["moe_aux"]) == 0.0


def test_prefill_matches_jax(model):
    toks = np.random.default_rng(8).integers(
        1, model["cfg"].vocab_size, (3, 40)).astype(np.int32)
    with torch.no_grad():
        tl, tc = T.prefill(model["cfg"], model["tp"], {"tokens": toks})
    jl, jc = jT.prefill(model["jcfg"], model["jp"],
                        {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == set(jc) == {"rwkv"}
    close_state(tc["rwkv"], jc["rwkv"])


def test_make_cache_matches_jax(model):
    tc = T.make_cache(model["cfg"], 3, 100, "cpu")
    jc = jT.make_cache(model["jcfg"], 3, 100)
    assert set(tc) == set(jc) == {"rwkv"}
    for key in STATE_KEYS:
        assert tuple(tc["rwkv"][key].shape) == jc["rwkv"][key].shape
        assert tc["rwkv"][key].dtype == torch.float32
        assert not tc["rwkv"][key].any()


def test_decode_step_matches_jax_teacher_forced(model):
    """Prefill, then decode a fixed token sequence; logits and the state
    after every step match JAX, and the state is updated in place."""
    cfg, jcfg, t = model["cfg"], model["jcfg"], 32
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, cfg.vocab_size, (2, t)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    _, jc = jT.prefill(jcfg, model["jp"], {"tokens": jnp.asarray(prompt)})
    with torch.no_grad():
        _, tpc = T.prefill(cfg, model["tp"], {"tokens": prompt})
        tc = graft(T.make_cache(cfg, 2, t + 8, "cpu"), tpc)
        assert tc["rwkv"] is tpc["rwkv"]
        wkv = tc["rwkv"]["wkv"]
        for i in range(forced.shape[1]):
            jl, jc = jT.decode_step(jcfg, model["jp"],
                                    jnp.asarray(forced[:, i]), jc,
                                    jnp.int32(t + i))
            tl, tc2 = T.decode_step(cfg, model["tp"],
                                    torch.from_numpy(forced[:, i]), tc, t + i)
            assert tc2 is tc and tc["rwkv"]["wkv"] is wkv
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
            close_state(tc["rwkv"], jc["rwkv"])


def test_decode_matches_prefill(model):
    """Decoding the last token after a prefill of the others gives the
    logits of a prefill over all of them (mirrors
    tests/test_prefill_decode_consistency.py for rwkv6)."""
    cfg, params = model["cfg"], model["tp"]
    t = 96
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, t))
    with torch.no_grad():
        want, _ = T.prefill(cfg, params, {"tokens": toks})
        _, pcache = T.prefill(cfg, params, {"tokens": toks[:, :-1]})
        cache = graft(T.make_cache(cfg, 2, t + 4, "cpu"), pcache)
        got, _ = T.decode_step(cfg, params, toks[:, -1], cache, t - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------- generation

def test_greedy_generate_matches_jax(model):
    cfg, t, n = model["cfg"], 32, 6
    prompt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, t)).astype(np.int32)
    toks, liks = greedy_generate(cfg, model["tp"], {"tokens": prompt}, n)
    assert toks.shape == liks.shape == (2, n)
    assert toks.dtype == torch.int32 and liks.dtype == torch.float32
    # every step's top-2 gap, from a teacher-forced replay
    with torch.no_grad():
        logits, pc = T.prefill(cfg, model["tp"], {"tokens": prompt})
        cache = graft(T.make_cache(cfg, 2, t + n, "cpu"), pc)
        gaps = []
        for i in range(n):
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            logits, cache = T.decode_step(cfg, model["tp"], toks[:, i], cache,
                                          t + i)
    assert min(gaps) > GAP, f"inputs: a top-2 logit gap of {min(gaps)}"
    jtoks, jliks = jax_generate(model["jcfg"], model["jp"],
                                {"tokens": jnp.asarray(prompt)}, n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(liks.numpy(), np.asarray(jliks), atol=1e-5)


def test_greedy_generate_is_self_consistent(model):
    """Token i chosen by the decode loop == argmax of a fresh prefill over
    prompt + tokens[:i] (mirrors the JAX package's rwkv6 case)."""
    cfg, params = model["cfg"], model["tp"]
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 32))
    toks, liks = greedy_generate(cfg, params, {"tokens": prompt},
                                 max_new_tokens=4)
    assert bool(((liks > 0) & (liks <= 1)).all())
    seq = torch.from_numpy(prompt)
    with torch.no_grad():
        for i in range(4):
            logits, _ = T.prefill(cfg, params, {"tokens": seq})
            assert int(logits.argmax(-1)[0]) == int(toks[0, i]), i
            seq = torch.cat([seq, toks[:, i:i + 1].long()], dim=1)


# ------------------------------------------------------------ serving

N_REQ, BATCH, NCLS = 48, 16, 8
SCFG = dict(name="local", vocab_size=128, max_len=24, d_model=32,
            num_heads=2, d_ff=32, num_classes=NCLS, dropout=0.0)


def gap_cut(conf: np.ndarray) -> float:
    c = np.sort(conf.astype(np.float64))
    lo, hi = len(c) // 4, 3 * len(c) // 4
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    return float((c[i] + c[i + 1]) / 2)


def test_serving_slice_with_rwkv6_remote_matches_jax(model):
    """The window path of both packages' ServeConfig.build with the
    reduced rwkv6 as the remote tier (what ``--remote-arch rwkv6-1.6b
    --smoke`` serves): every response and the billing are equal. Before
    comparing, no local confidence lies within 1e-4 of t_local and no
    remote confidence within 1e-4 of t_remote."""
    jscfg = jS.SurrogateConfig(**SCFG)
    sp = jax.tree.map(np.asarray, jS.init_params(jscfg,
                                                 jax.random.PRNGKey(0)))
    sp["out"]["w"] = sp["out"]["w"] * 30.0       # spread the confidences
    toks, labels, _ = make_classification_task(
        1, n=N_REQ, vocab=512, seq_len=48, num_classes=NCLS)
    toks = toks % model["cfg"].vocab_size
    local_toks = (toks[:, :24] % 128).astype(np.int32)
    oracle = np.eye(NCLS, dtype=np.float32)[labels] * 2.0
    jsp = jax.tree.map(jnp.asarray, sp)
    tsp, tscfg = params_from_jax(sp, "cpu"), S.SurrogateConfig(**SCFG)
    toracle = torch.from_numpy(oracle)

    def jremote(batch):
        logits, _ = jT.prefill(model["jcfg"], model["jp"],
                               {"tokens": jnp.asarray(batch["tokens"])})
        return jnp.asarray(oracle)[jnp.asarray(batch["idx"])] \
            + logits[:, :NCLS]

    @torch.no_grad()
    def tremote(batch):
        logits, _ = T.prefill(model["cfg"], model["tp"],
                              {"tokens": batch["tokens"]})
        idx = torch.as_tensor(np.asarray(batch["idx"])).long()
        return toracle[idx] + logits[:, :NCLS]

    @torch.no_grad()
    def tlocal(tk):
        return S.apply(tscfg, tsp, tk)

    local_conf = max_softmax(tlocal(torch.from_numpy(local_toks))).numpy()
    remote_conf = max_softmax(tremote(
        {"tokens": toks, "idx": np.arange(N_REQ)})).numpy()
    t_local, t_remote = gap_cut(local_conf), gap_cut(remote_conf)
    assert np.abs(local_conf - t_local).min() > GAP, "inputs: local conf"
    assert np.abs(remote_conf - t_remote).min() > GAP, "inputs: remote conf"

    base = dict(batch_size=BATCH, remote_fraction_budget=1.0,
                t_local=t_local, t_remote=t_remote)
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            cfg = JaxServeConfig(**base).with_overrides(
                ["transport.timeout_s=300"])
            req, kw = JaxRequest, {}
            loc, rem = (lambda tk: jS.apply(jscfg, jsp, tk)), jremote
        else:
            cfg = ServeConfig(**base).with_overrides(
                ["transport.timeout_s=300"])
            req, kw = Request, {"device": "cpu"}
            loc, rem = tlocal, tremote
        eng, sched = cfg.build(loc, transport=cfg.build_router(rem),
                               fallback=lambda r: -1, **kw)
        try:
            for i in range(N_REQ):
                sched.submit(req(uid=i, local_input=local_toks[i],
                                 remote_input={"tokens": toks[i],
                                               "idx": np.int32(i)}))
            responses = sched.flush()
        finally:
            eng.close()
        assert eng.stats.transport_failures == 0, (pkg, eng.stats)
        out.append((sorted(responses, key=lambda r: r.uid), eng.stats))
    (jr, js), (tr, ts) = out
    assert len(tr) == N_REQ
    fields = ("uid", "prediction", "source", "disposition", "backend", "cost")
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields], a.uid
    for f in BILLING_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f
    assert 0 < ts.escalations < N_REQ


def test_serve_main_runs_rwkv6_remote_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--remote-arch", ARCH,
                       "--requests", "32", "--batch", "16"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 32 requests" in out and "remote tier rwkv6-1.6b-smoke" \
        in out
