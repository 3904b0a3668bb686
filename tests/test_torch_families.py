"""The attention family's other members in the PyTorch port against the
JAX package: MoE (``models/moe.py``), MLA (``models/mla.py``) and the
transformer's dense-then-MoE stacks, on reduced configs — deepseek-v2-lite
(MLA + MoE with a shared expert, one dense layer), qwen3-moe (GQA + MoE,
no shared expert), qwen2-7b (QKV bias), deepseek-67b, and h2o-danube at
head dim 80 (d_model 320 over 4 heads, 2 KV heads; window 64, so the
96-token prompt wraps the ring). JAX's parameters reach the port through
``params_from_jax``; tokens and activations come from numpy seeds; the
port runs on the CPU.

Tolerances (all fp32): the MoE router's top-k experts, its drop mask and
the generated tokens exact (each decided by gaps checked first); MoE
outputs 1e-5 and the aux loss rtol 1e-5 (one or two f32 matmuls of width
128-256 summed in another order); MLA outputs and latents 1e-5; prefill
and decode logits and caches 1e-4 (two layers of f32 matmuls, as for
yi-6b); likelihoods 1e-5; loss, ce and moe_aux rtol 1e-5 and every
gradient leaf within 1e-4 * max|g| + 1e-7, as the train tests hold
yi-6b.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.serving.generate import graft  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import jax_leaves, tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from tests.test_torch_generate import (graft_jax, teacher_forced_logits,  # noqa: E402
                                       top2_gap)

HD80 = "h2o-danube-1.8b@hd80"
# arch -> prompt length (h2o-danube's passes its window of 64)
ARCHS = {"deepseek-v2-lite-16b": 40, "qwen3-moe-235b-a22b": 40,
         "qwen2-7b": 40, "deepseek-67b": 40, HD80: 96}
MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
GAP = 1e-4


def configs(arch: str, dtype: str = "float32"):
    """(JAX config, port config): the reduced config of ``arch``; for
    HD80 h2o-danube's, widened to d_model 320 over 4 heads of 80 and 2
    KV heads."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(arch.split("@")[0]).reduced()
        if arch == HD80:
            cfg = dataclasses.replace(cfg, d_model=320, num_heads=4,
                                      num_kv_heads=2)
            assert cfg.resolved_head_dim == 80
        out.append(dataclasses.replace(cfg, dtype=dtype))
    return out


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' operations are too small to gain from torch's
    threads; one keeps them from contending with the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """JAX's parameters of ``arch``, carried into the port, and JAX's
    prefill and decode step, each compiled once."""
    arch = request.param
    jcfg, cfg = configs(arch)
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(2))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, tp=carry(jp),
                t=ARCHS[arch],
                prefill=jax.jit(lambda p, b: jT.prefill(jcfg, p, b)),
                decode=jax.jit(lambda p, tok, c, pos: jT.decode_step(
                    jcfg, p, tok, c, pos)))


# ---------------------------------------------------------------- init

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_tree_shapes_and_dtypes_match_jax(arch, dtype):
    """The same tree, leaf shapes and dtypes as JAX's ``init_params``
    (in bf16 the MoE router stays fp32)."""
    jcfg, cfg = configs(arch, dtype)
    jp = jax.eval_shape(lambda: jT.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                    tp) == jax.tree.map(lambda a: (tuple(a.shape),
                                                   str(a.dtype)), jp)


def test_params_from_jax_recast_keeps_the_router_fp32():
    """A recast to bf16 leaves the MoE router as JAX keeps it, in fp32
    and bit for bit, and casts the experts."""
    jp = jax.jit(jmoe.moe_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), configs("deepseek-v2-lite-16b")[0],
        jnp.float32)
    host = jax.tree.map(np.asarray, jp)
    cast = params_from_jax(host, "cpu", dtype=torch.bfloat16)
    assert cast["router"]["w"].dtype == torch.float32
    assert torch.equal(cast["router"]["w"],
                       torch.tensor(host["router"]["w"]))
    for leaf in tree_leaves({k: v for k, v in cast.items() if k != "router"}):
        assert leaf.dtype == torch.bfloat16


# ----------------------------------------------------------------- MoE

def moe_layer(arch: str):
    """One reduced MoE layer's JAX params and activations [2, 48, D]
    from a numpy seed, of mean 0.25, with the router's column 0 raised by
    0.02: expert 0's logit gains ~1.3, so most tokens pick it and it
    overflows its capacity at a capacity factor of 1.25."""
    jcfg, cfg = configs(arch)
    jp = jmoe.moe_params(jax.random.PRNGKey(4), jcfg, jnp.float32)
    w = np.array(jp["router"]["w"])
    w[:, 0] += 0.02
    jp["router"]["w"] = jnp.asarray(w)
    x = (np.random.default_rng(9).standard_normal((2, 48, cfg.d_model))
         + 0.25).astype(np.float32)
    return jcfg, cfg, jp, x


@pytest.mark.parametrize("mode", ["dropless", 1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, mode):
    jcfg, cfg, jp, x = moe_layer(arch)
    dropless = mode == "dropless"
    cf = None if dropless else mode
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_forward(
        jcfg, p, x, capacity_factor=cf, dropless=dropless))(jp, jnp.asarray(x))
    tp = carry(jp)
    with torch.no_grad():
        ty, taux = moe.moe_forward(cfg, tp, torch.from_numpy(x),
                                   capacity_factor=cf, dropless=dropless)

    # the router: JAX's top-k, with gaps between the k-th and (k+1)-th
    # probability so the choice is decided
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    probs = jax.nn.softmax(xf @ jp["router"]["w"], -1)
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    srt = np.sort(np.asarray(probs), -1)[:, ::-1]
    assert (srt[:, k - 1] - srt[:, k]).min() > 1e-5
    jtp, jte = jax.lax.top_k(probs, k)
    te, tpr, _ = moe.route(cfg, tp, torch.from_numpy(np.array(xf)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    np.testing.assert_allclose(tpr.numpy(), np.asarray(
        jtp / jtp.sum(-1, keepdims=True)), atol=1e-6)

    # the drop mask: JAX sends a dropped pair to its spare row e * cap
    m = xf.shape[0]
    cap = (m + 7) // 8 * 8 if dropless else moe.capacity(cfg, m, cf)
    _, flat_idx, _ = jmoe._group_dispatch(xf, jte, jtp, e, k, cap)
    jkeep = np.asarray(flat_idx != e * cap).reshape(m, k)
    keep = moe.keep_mask(te, e, cap)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if dropless:
        assert jkeep.all()
    else:
        assert not jkeep.all(), "the test needs dropped pairs"

    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_capacity_matches_jax_formula():
    _, cfg = configs("qwen3-moe-235b-a22b")
    for m, cf in ((96, 1.25), (96, 0.5), (7, 0.1), (1000, 2.0)):
        want = max(int(m * cfg.num_experts_per_tok * cf / cfg.num_experts),
                   1)
        assert moe.capacity(cfg, m, cf) == (want + 7) // 8 * 8


# ----------------------------------------------------------------- MLA

@pytest.fixture(scope="module")
def mla_layer():
    jcfg, cfg = configs("deepseek-v2-lite-16b")
    jp = jmla.mla_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    return jcfg, cfg, jp, carry(jp)


@pytest.mark.parametrize("t,q_chunk", [(40, 1024), (64, 32)])
def test_mla_forward_matches_jax(mla_layer, t, q_chunk):
    jcfg, cfg, jp, tp = mla_layer
    x = np.random.default_rng(t).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    pos = np.arange(t)
    jout, (jc, jk) = jax.jit(lambda p, x, pos: jmla.mla_forward(
        jcfg, p, x, pos, q_chunk=q_chunk))(jp, jnp.asarray(x),
                                           jnp.asarray(pos))
    with torch.no_grad():
        out, (c, kr) = mla.mla_forward(cfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(pos), q_chunk=q_chunk)
    for got, want in ((out, jout), (c, jc), (kr, jk)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        mla.mla_forward(cfg, tp, torch.zeros(1, 48, cfg.d_model),
                        torch.arange(48), q_chunk=32)


def test_mla_decode_matches_jax_on_a_grafted_cache(mla_layer):
    """The absorbed decode after a naive prefill's latents are grafted
    into a cache: out and both caches, three steps."""
    jcfg, cfg, jp, tp = mla_layer
    rng = np.random.default_rng(6)
    t, s = 24, 32
    x = rng.standard_normal((2, t + 3, cfg.d_model)).astype(np.float32)
    _, (jc, jk) = jmla.mla_forward(jcfg, jp, jnp.asarray(x[:, :t]),
                                   jnp.arange(t))
    jcache = jmla.make_mla_cache(jcfg, 2, s, jnp.float32, layers=1)
    jcache = graft_jax(jcache, {"c_kv": jc[None], "k_rope": jk[None]})
    jck, jkr = jcache["c_kv"][0], jcache["k_rope"][0]
    tcache = mla.make_mla_cache(cfg, 2, s, torch.float32, layers=1,
                                device=torch.device("cpu"))
    with torch.no_grad():
        _, (c, kr) = mla.mla_forward(cfg, tp, torch.from_numpy(x[:, :t]),
                                     torch.arange(t))
        tcache = graft({"main": tcache},
                       {"main": {"c_kv": c[None], "k_rope": kr[None]}})["main"]
        tck, tkr = tcache["c_kv"][0], tcache["k_rope"][0]
        jdecode = jax.jit(lambda *a: jmla.mla_decode(jcfg, jp, *a))
        for i in range(3):
            pos = t + i
            xi = x[:, pos:pos + 1]
            jout, jck, jkr = jdecode(jnp.asarray(xi), jck, jkr,
                                     jnp.int32(pos))
            out, ck2, _ = mla.mla_decode(cfg, tp, torch.from_numpy(xi), tck,
                                         tkr, pos, torch.tensor([pos]))
            assert ck2 is tck                    # written in place
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       atol=1e-5)
            np.testing.assert_allclose(tck.numpy(), np.asarray(jck),
                                       atol=1e-5)
            np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr),
                                       atol=1e-5)


# -------------------------------------------- prefill, decode, generate

def test_prefill_matches_jax(model):
    cfg, t = model["cfg"], model["t"]
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, (3, t))
    jl, jc = model["prefill"](model["jp"], {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(cfg, model["tp"], {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == set(jc)
    for group in jc:
        assert set(tc[group]) == set(jc[group])
        for key, want in jc[group].items():
            assert tuple(tc[group][key].shape) == want.shape
            np.testing.assert_allclose(tc[group][key].numpy(),
                                       np.asarray(want), atol=1e-4,
                                       err_msg=f"{group}/{key}")


def test_make_cache_matches_jax(model):
    tc = T.make_cache(model["cfg"], 3, 100, "cpu")
    jc = jT.make_cache(model["jcfg"], 3, 100)
    assert tree_map(lambda a: tuple(a.shape), tc) == \
        jax.tree.map(lambda a: tuple(a.shape), jc)
    assert not any(bool(a.any()) for a in tree_leaves(tc))


def test_decode_step_matches_jax_teacher_forced(model):
    """Prefill, then a fixed token sequence through ``decode_step``: the
    logits and every cache leaf after each step match JAX's."""
    cfg, jcfg, t = model["cfg"], model["jcfg"], model["t"]
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, cfg.vocab_size, (2, t)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    _, jpc = model["prefill"](model["jp"], {"tokens": jnp.asarray(prompt)})
    jc = graft_jax(jT.make_cache(jcfg, 2, t + 6), jpc)
    with torch.no_grad():
        _, tpc = T.prefill(cfg, model["tp"], {"tokens": prompt})
        tc = graft(T.make_cache(cfg, 2, t + 6, "cpu"), tpc)
        for i in range(forced.shape[1]):
            jl, jc = model["decode"](model["jp"], jnp.asarray(forced[:, i]),
                                     jc, jnp.int32(t + i))
            tl, tc2 = T.decode_step(cfg, model["tp"], forced[:, i], tc,
                                    t + i)
            assert tc2 is tc                       # updated in place
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for got, want in zip(jax_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_greedy_generate_matches_jax(model):
    cfg, t, n = model["cfg"], model["t"], 5
    prompt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, t)).astype(np.int32)
    toks, liks = greedy_generate(cfg, model["tp"], {"tokens": prompt}, n)
    assert toks.shape == liks.shape == (2, n)
    gaps = [top2_gap(lg) for lg in teacher_forced_logits(
        cfg, model["tp"], torch.from_numpy(prompt), toks)]
    assert min(gaps) > GAP, f"inputs: a top-2 logit gap of {min(gaps)}"
    jtoks, jliks = jax_generate(model["jcfg"], model["jp"],
                                {"tokens": jnp.asarray(prompt)}, n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(liks.numpy(), np.asarray(jliks), atol=1e-5)


# ------------------------------------------------------- loss, gradients

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """``loss_fn`` (ce plus router_aux_loss_coef * moe_aux, the MoE layers
    at their training capacity) and the gradient of every leaf, the
    router's through the renormalised top-k probabilities and the aux
    loss."""
    jcfg, cfg = configs(arch)
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(7))
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 32)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, tm, tg = loop.value_and_grad(cfg, carry(jp), {"tokens": toks})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["moe_aux"]) > 0
    for key in ("ce", "acc", "moe_aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = jax.tree.leaves(jg)
    got = jax_leaves(tg)
    assert len(got) == len(want) == len(tree_leaves(tg))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)
