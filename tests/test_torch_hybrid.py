"""The zamba hybrid in the PyTorch port against the JAX package: the
mamba2 mixer (``models/mamba2.py``) and the zamba stack of
``models/transformer.py`` (groups of a shared attention block, then
mamba2 layers), on reduced zamba2-7b with 2 groups (4 layers, a shared
block every 2; the default reduced config has one group, which would hide
a regrouping error) at head dim 64 and widened to the full model's head
dim of 112 (d_model 448 over 4 heads). JAX's parameters reach the port
through ``params_from_jax``; inputs come from numpy seeds; the port runs
on the CPU.

Tolerances (all fp32): module outputs and states 1e-5 (f32 matmuls of
width 256-896 and a per-token recurrence summed in another order);
prefill and decode logits and caches 1e-4, generated tokens exact (after
checking every step's top-2 logit gap), likelihoods 1e-5; loss rtol 1e-5
and every gradient leaf within 1e-4 * max|g| + 1e-7, as the train tests
hold yi-6b.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.serving.generate import graft  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import jax_leaves, tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from tests.test_torch_generate import (graft_jax, teacher_forced_logits,  # noqa: E402
                                       top2_gap)

ARCH = "zamba2-7b"
# name -> (d_model, heads): 2 groups of 2 mamba2 layers each
CASES = {"zamba2-2groups": (256, 4), "zamba2-hd112": (448, 4)}
GAP = 1e-4


def configs(case: str, dtype: str = "float32"):
    """(JAX config, port config) of reduced zamba2 with 4 layers in 2
    groups, at ``case``'s width."""
    d, h = CASES[case]
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(get(ARCH).reduced(), num_layers=4,
                                  shared_attn_period=2, d_model=d,
                                  num_heads=h, num_kv_heads=h, dtype=dtype)
        out.append(cfg)
    assert out[1].resolved_head_dim == d // h
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


# ---------------------------------------------------------------- mamba2

@pytest.fixture(scope="module")
def mixer():
    """One reduced mamba2 layer's JAX params, with every per-head constant
    (a_log, dt_bias, d_skip) drawn apart per head from a numpy seed, so
    that channels given to the wrong head (a P-major layout read
    head-major) change the output."""
    jcfg, cfg = configs("zamba2-2groups")
    jp = jm2.mamba2_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    _, h, _ = m2.dims(cfg)
    assert h > 1
    jp["a_log"] = jnp.asarray(rng.uniform(-1.0, 2.0, h), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 1.0, h), jnp.float32)
    jp["d_skip"] = jnp.asarray(rng.uniform(0.0, 2.0, h), jnp.float32)
    return jcfg, cfg, jp, carry(jp)


def jax_state(cfg, rng, b):
    d_inner, h, n = m2.dims(cfg)
    return {"ssm": rng.standard_normal((b, h, m2.HEAD_P, n)),
            "conv_x": rng.standard_normal((b, m2.CONV_W - 1, d_inner)),
            "conv_bc": rng.standard_normal((b, m2.CONV_W - 1, 2 * n))}


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(mixer, with_state):
    jcfg, cfg, jp, tp = mixer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    st = ({k: v.astype(np.float32) for k, v in jax_state(cfg, rng, 2).items()}
          if with_state else None)
    jy, jst = jax.jit(lambda p, x, s: jm2.mamba2_forward(jcfg, p, x, s))(
        jp, jnp.asarray(x), st)
    with torch.no_grad():
        ty, tst = m2.mamba2_forward(
            cfg, tp, torch.from_numpy(x),
            None if st is None else tree_map(torch.from_numpy, st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert set(tst) == set(jst)
    for key in jst:
        assert tst[key].dtype == torch.float32
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=1e-5, err_msg=key)


def test_mamba2_decode_token_by_token_matches_a_forward(mixer):
    """``mamba2_decode`` one token at a time from a forward's state over a
    prefix gives what one forward over the whole sequence gives, and what
    JAX's decode gives at each step."""
    jcfg, cfg, jp, tp = mixer
    x = np.random.default_rng(6).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    jdecode = jax.jit(lambda p, x, s: jm2.mamba2_decode(jcfg, p, x, s))
    with torch.no_grad():
        whole, whole_st = m2.mamba2_forward(cfg, tp, xt)
        _, st = m2.mamba2_forward(cfg, tp, xt[:, :12])
        _, jst = jm2.mamba2_forward(jcfg, jp, jnp.asarray(x[:, :12]))
        for i in range(12, 20):
            y, st = m2.mamba2_decode(cfg, tp, xt[:, i:i + 1], st)
            jy, jst = jdecode(jp, jnp.asarray(x[:, i:i + 1]), jst)
            np.testing.assert_allclose(y.numpy(), whole[:, i:i + 1].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    for key in whole_st:
        np.testing.assert_allclose(st[key].numpy(), whole_st[key].numpy(),
                                   atol=1e-5, err_msg=key)


def test_mamba2_channels_are_p_major(mixer):
    """Channel ``p * h + head`` of d_inner belongs to head ``head``: a
    perturbation of x's in-projection column for channel (p=0, head=1)
    moves head 1's state only."""
    _, cfg, _, tp = mixer
    d_inner, h, _ = m2.dims(cfg)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32))
    bumped = tree_map(torch.clone, tp)
    bumped["w_zx"]["w"][:, d_inner + 0 * h + 1] += 1.0   # x channel p=0, h=1
    with torch.no_grad():
        _, a = m2.mamba2_forward(cfg, tp, x)
        _, b = m2.mamba2_forward(cfg, bumped, x)
    moved = (a["ssm"] - b["ssm"]).abs().amax((0, 2, 3))   # per head
    assert moved[1] > 0
    assert float(moved[torch.arange(h) != 1].max()) == 0.0


def test_mamba2_state_matches_jax():
    jcfg, cfg = configs("zamba2-hd112")
    js = jm2.mamba2_state(jcfg, 3)
    ts = m2.mamba2_state(cfg, 3, device=torch.device("cpu"))
    assert tree_map(lambda a: (tuple(a.shape), a.dtype), ts) == \
        {k: (v.shape, torch.float32) for k, v in js.items()}


# ---------------------------------------------------------- zamba stack

@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    """JAX's parameters of the case, carried into the port, and JAX's
    prefill and decode step, each compiled once."""
    jcfg, cfg = configs(request.param)
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(2))
    return dict(case=request.param, jcfg=jcfg, cfg=cfg, jp=jp, tp=carry(jp),
                prefill=jax.jit(lambda p, b: jT.prefill(jcfg, p, b)),
                decode=jax.jit(lambda p, tok, c, pos: jT.decode_step(
                    jcfg, p, tok, c, pos)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_init_params_tree_shapes_and_dtypes_match_jax(case, dtype):
    """The same tree (stacked ``blocks`` of norm and mixer, one unstacked
    ``shared_attn``), leaf shapes and dtypes as JAX's (mamba2's per-head
    constants fp32 in bf16)."""
    jcfg, cfg = configs(case, dtype)
    jp = jax.eval_shape(lambda: jT.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                    tp) == jax.tree.map(lambda a: (tuple(a.shape),
                                                   str(a.dtype)), jp)
    assert tp["blocks"]["mixer"]["a_log"].dtype == torch.float32


def test_zamba_groups_refuse_a_ragged_period():
    _, cfg = configs("zamba2-2groups")
    assert T.zamba_groups(cfg) == (2, 2)
    with pytest.raises(ValueError, match="groups"):
        T.zamba_groups(dataclasses.replace(cfg, num_layers=5))


def test_prefill_matches_jax(model):
    cfg = model["cfg"]
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, (3, 40))
    jl, jc = model["prefill"](model["jp"], {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(cfg, model["tp"], {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert tree_map(lambda a: tuple(a.shape), tc) == \
        jax.tree.map(lambda a: tuple(a.shape), jc)
    assert tuple(tc["attn_k"].shape) == (2, 3, 40, cfg.num_kv_heads,
                                         cfg.resolved_head_dim)
    for got, want in zip(jax_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_forward_matches_jax(model):
    cfg = model["cfg"]
    toks = np.random.default_rng(11).integers(1, cfg.vocab_size, (2, 32))
    jx, _ = jT.forward(model["jcfg"], model["jp"],
                       {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tx, extras = T.forward(cfg, model["tp"], {"tokens": toks})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    assert float(extras["moe_aux"]) == 0.0


def test_make_cache_matches_jax(model):
    tc = T.make_cache(model["cfg"], 3, 100, "cpu")
    jc = jT.make_cache(model["jcfg"], 3, 100)
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                    tc) == jax.tree.map(lambda a: (tuple(a.shape),
                                                   str(a.dtype)), jc)
    assert not any(bool(a.any()) for a in tree_leaves(tc))


def test_graft_takes_the_state_and_fills_the_kv_slots(model):
    """The grafted cache: the mamba2 state is the prefill's own, the
    per-group KV leaves hold the prompt's slots and zeros after."""
    cfg = model["cfg"]
    toks = np.random.default_rng(12).integers(1, cfg.vocab_size, (2, 16))
    with torch.no_grad():
        _, pc = T.prefill(cfg, model["tp"], {"tokens": toks})
        c = graft(T.make_cache(cfg, 2, 20, "cpu"), pc)
    assert all(c["mamba"][k] is pc["mamba"][k] for k in pc["mamba"])
    for key in ("attn_k", "attn_v"):
        assert torch.equal(c[key][:, :, :16], pc[key])
        assert not bool(c[key][:, :, 16:].any())


def test_decode_step_matches_jax_on_a_grafted_cache(model):
    """Prefill, then a fixed token sequence through ``decode_step``: the
    logits after each step and every cache leaf at the end match JAX's,
    and the port updates its cache in place."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(8)
    t = 40
    prompt = rng.integers(1, cfg.vocab_size, (2, t)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    _, jpc = model["prefill"](model["jp"], {"tokens": jnp.asarray(prompt)})
    jc = graft_jax(jT.make_cache(jcfg, 2, t + 6), jpc)
    with torch.no_grad():
        _, tpc = T.prefill(cfg, model["tp"], {"tokens": prompt})
        tc = graft(T.make_cache(cfg, 2, t + 6, "cpu"), tpc)
        ssm = tc["mamba"]["ssm"]
        for i in range(forced.shape[1]):
            jl, jc = model["decode"](model["jp"], jnp.asarray(forced[:, i]),
                                     jc, jnp.int32(t + i))
            tl, tc2 = T.decode_step(cfg, model["tp"], forced[:, i], tc, t + i)
            assert tc2 is tc and tc["mamba"]["ssm"] is ssm   # in place
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for got, want in zip(jax_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_greedy_generate_matches_jax(model):
    cfg, n = model["cfg"], 5
    prompt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 24)).astype(np.int32)
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

@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_leaf_match_jax(case):
    """``loss_fn`` and the gradient of every leaf, the shared block's
    summed over its groups, each mamba2 layer's through its recurrence."""
    jcfg, cfg = configs(case)
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(7))
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 32)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, tm, tg = loop.value_and_grad(cfg, carry(jp), {"tokens": toks})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("ce", "acc"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = jax.tree.leaves(jg)
    got = jax_leaves(tg)
    assert len(got) == len(want) == len(tree_leaves(tg))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


def test_remat_gives_the_same_gradients():
    _, cfg = configs("zamba2-2groups")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 16))
    _, _, g0 = loop.value_and_grad(cfg, params, {"tokens": toks},
                                   remat=False)
    _, _, g1 = loop.value_and_grad(cfg, params, {"tokens": toks}, remat=True)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()) + 1e-9)


def test_serve_main_runs_zamba2_remote_on_cpu(capsys):
    """``--remote-arch zamba2-7b --smoke``: the reduced hybrid serves the
    token task through a tokens prefill, as JAX's remote tier does."""
    assert serve.main(["--device", "cpu", "--smoke", "--remote-arch", ARCH,
                       "--requests", "32", "--batch", "16"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 32 requests" in out and "remote tier zamba2-7b-smoke" \
        in out
