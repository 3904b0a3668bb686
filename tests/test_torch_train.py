"""The port's train path against the JAX package: ``loss_fn``, its
gradients, the in-place AdamW step, ``train_loop`` and the launcher.

Reduced yi-6b, h2o-danube (its window of 64 masks at T = 128) and rwkv6,
all fp32, on JAX's parameters carried over with ``params_from_jax`` and
tokens from a numpy seed; one JAX compile of ``value_and_grad(loss_fn)``
per configuration, shared by the module.

Tolerances: loss, ce and acc rtol 1e-5 (f32 matmuls and a logsumexp
summed in another order); every gradient leaf within
``GRAD_TOL * max|g_jax| + 1e-7``: 1e-4 for the attention models (two
layers of f32 backward), 2e-3 for rwkv6. Its gradients of the leaves that
feed r and k (``wr``, ``wk``, ``bonus_u``, their token-shift mixes, the
embedding) amplify the f32 rounding of the projections about 1e4-fold at
these weights: evaluated in float64 (``jax.enable_x64`` with every f32
cast made f64), JAX's own f32 gradient is 6.7e-4 * max|g| away on
``bonus_u`` and the port's 1.4e-3 (7e-5 with its matmuls in float64; the
recurrence and the group norm in float64 move it by under 1e-5), so the
two f32 results differ by up to 7.7e-4. Further: remat against no remat
1e-6 (the same operations recomputed); the in-place AdamW step bit for
bit against the functional one, which is held to JAX's ``adamw_update``
on JAX's gradients within 1e-6 (params) and rtol 1e-5 (moments); a
5-step ``train_loop`` loss history within 1e-3 relative (each package
steps from its own gradients, and AdamW's first steps move every weight
by about lr * sign(g), so a gradient near 0 of the other sign separates
the two by 2 lr).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.tree import jax_leaves, tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEQ = {"yi-6b": 64, "h2o-danube-1.8b": 128, "rwkv6-1.6b": 64}
GRAD_TOL = {"yi-6b": 1e-4, "h2o-danube-1.8b": 1e-4, "rwkv6-1.6b": 2e-3}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' operations are too small to gain from
    threads; one keeps them from contending with the other test
    workers' (the RWKV6 recurrence runs a few ops per token)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module", params=list(SEQ))
def case(request):
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(7))
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, SEQ[arch])).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    tl, tm, tg = loop.value_and_grad(cfg, carry(jp), {"tokens": toks})
    return {"arch": arch, "cfg": cfg, "jcfg": jcfg, "jp": jp,
            "toks": toks, "jl": jl, "jm": jm, "jg": jg, "tl": tl, "tm": tm,
            "tg": tg}


def test_window_masks_at_the_tested_length(case):
    if case["cfg"].sliding_window:
        assert case["cfg"].sliding_window < case["toks"].shape[1]


def test_loss_fn_matches_jax(case):
    np.testing.assert_allclose(float(case["tl"]), float(case["jl"]),
                               rtol=1e-5)
    for k in ("ce", "acc"):
        np.testing.assert_allclose(float(case["tm"][k]),
                                   float(case["jm"][k]), rtol=1e-5)
    assert float(case["tm"]["moe_aux"]) == 0.0


def test_every_gradient_leaf_matches_jax(case):
    want = jax.tree.leaves(case["jg"])
    got = jax_leaves(case["tg"])
    assert len(got) == len(want) == len(tree_leaves(case["tg"]))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(w).max() > 0
        tol = GRAD_TOL[case["arch"]] * np.abs(w).max() + 1e-7
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def test_remat_gives_the_same_gradients(case):
    _, _, g0 = loop.value_and_grad(case["cfg"], carry(case["jp"]),
                                   {"tokens": case["toks"]}, remat=False)
    for a, b in zip(tree_leaves(g0), tree_leaves(case["tg"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_inplace_step_is_the_functional_step_and_matches_jax(case):
    jg = case["jg"]
    grads = carry(jg)
    cfg = opt.AdamWConfig(**OPT)
    params = carry(case["jp"])
    state = opt.init_opt_state(params)
    inplace = tree_map(torch.clone, params)
    istate = opt.init_opt_state(inplace)
    jp, js = case["jp"], jopt.init_opt_state(case["jp"])
    jstep = jax.jit(lambda p, g, s: jopt.adamw_update(
        jopt.AdamWConfig(**OPT), p, g, s))
    for _ in range(2):
        params, state, stats = opt.adamw_update(cfg, params, grads, state)
        istats = opt.adamw_step_(cfg, inplace, grads, istate)
        jp, js, jstats = jstep(jp, jg, js)
        assert torch.equal(stats["grad_norm"], istats["grad_norm"])
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert stats["lr"] == istats["lr"]
        np.testing.assert_allclose(stats["lr"], float(jstats["lr"]),
                                   rtol=1e-6)
    assert state["step"] == istate["step"] == int(js["step"]) == 2
    for a, b in zip(tree_leaves(params), tree_leaves(inplace)):
        assert torch.equal(a, b)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(state[key]), tree_leaves(istate[key])):
            assert torch.equal(a, b)
        for a, b in zip(jax_leaves(state[key]), jax.tree.leaves(js[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-12)
    for a, b in zip(jax_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_functional_step_leaves_its_inputs(case):
    params, grads = carry(case["jp"]), carry(case["jg"])
    state = opt.init_opt_state(params)
    before = [t.clone() for t in tree_leaves(params)]
    opt.adamw_update(opt.AdamWConfig(**OPT), params, grads, state)
    assert state["step"] == 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 before))
    assert all(not m.any() for m in tree_leaves(state["m"]))


def test_train_loop_history_matches_jax(case):
    def fixed(toks):
        while True:
            yield {"tokens": toks}

    _, jstate, jhist = jloop.train_loop(
        case["jcfg"], case["jp"], fixed(jnp.asarray(case["toks"])),
        jopt.AdamWConfig(**OPT), steps=5, log_every=1)
    _, state, hist = loop.train_loop(
        case["cfg"], carry(case["jp"]), fixed(case["toks"]),
        opt.AdamWConfig(**OPT), steps=5, log_every=1)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert state["step"] == int(jstate["step"]) == 5
    for h, j in zip(hist, jhist):
        assert set(h) == set(j)
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-3)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_train_loop_reduces_loss():
    """The port's copy of ``test_train_and_checkpoint.py``'s test."""
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    # a memorisable batch stream (8 fixed sequences)
    fixed = rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)

    def batches():
        while True:
            yield {"tokens": fixed}

    opt_cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                              weight_decay=0.0)
    params, _, hist = loop.train_loop(cfg, params, batches(), opt_cfg,
                                      steps=40, log_every=5)
    first, last = hist[0]["ce"], hist[-1]["ce"]
    assert last < first * 0.7, (first, last)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_step_updates_in_place_and_leaves_params_unmarked():
    cfg = get_config("rwkv6-1.6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    state = opt.init_opt_state(params)
    step = loop.make_train_step(cfg, opt.AdamWConfig(**OPT))
    before = [t.clone() for t in tree_leaves(params)]
    ids = [id(t) for t in tree_leaves(params)]
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 32))
    p2, s2, metrics = step(params, state, {"tokens": toks})
    assert p2 is params and s2 is state and state["step"] == 1
    assert [id(t) for t in tree_leaves(params)] == ids
    assert all(not t.requires_grad for t in tree_leaves(params))
    assert sum(not torch.equal(a, b)
               for a, b in zip(tree_leaves(params), before)) > 0
    assert set(metrics) == {"loss", "ce", "acc", "moe_aux", "grad_norm",
                            "lr"}
    assert all(not torch.is_tensor(v) or not v.requires_grad
               for v in metrics.values())


def test_value_and_grad_raises_on_a_leaf_without_gradient():
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    params["unused"] = torch.zeros(4)
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 16))
    with pytest.raises(RuntimeError, match="1 of the 22 parameter tensors"):
        loop.value_and_grad(cfg, params, {"tokens": toks})


def test_chunked_ce_refuses_a_length_off_the_chunk():
    x = torch.zeros(1, 600, 4)
    head = {"w": torch.zeros(4, 3)}
    y = torch.zeros(1, 600, dtype=torch.long)
    with pytest.raises(ValueError, match="multiple of the CE chunk"):
        T._chunked_ce(head, x, y, torch.ones(1, 600))


def test_optimizer_chunks_are_layer_slices():
    def shapes(*shape):
        t = torch.empty(shape, device="meta")
        return [tuple(c.shape) for c in opt._chunks(t)]
    assert shapes(3, 4096, 11008) == [(1, 4096, 11008)] * 3   # yi-6b MLP
    assert shapes(32, 4096, 4096) == [(2, 4096, 4096)] * 16
    assert shapes(32, 4096) == [(32, 4096)]
    assert shapes(64000, 4096) == [(8192, 4096)] * 7 + [(6656, 4096)]
    assert shapes() == [()]


def test_train_launcher_runs_on_the_cpu(tmp_path):
    ck = tmp_path / "ck.msgpack"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "3", "--checkpoint", str(ck)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "[train] step     1 loss=" in out.stdout
    assert ck.exists()
