"""Models, layers, core and optimizer of the PyTorch port against the JAX
package, on weights carried over with ``params_from_jax``.

Inputs and weights come from numpy seeds or from the JAX initialisers and
reach both packages as the same numbers; the port runs on the CPU.

Tolerances: f32 elementwise functions (norms, rope, supervisors) are held
to 1e-6 (one or two f32 roundings apart); the surrogate's logits to 1e-5
(a few f32 matmuls and a softmax summed in another order); the reduced
yi-6b prefill's logits and KV cache to 1e-4 (two layers of f32 matmuls of
width 256-512 summed in another order); one AdamW step to 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_MODULES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import cascade as jcascade  # noqa: E402
from repro.core import supervisors as jsup  # noqa: E402
from repro.core import thresholds as jthr  # noqa: E402
from repro.data.synthetic import make_classification_task as jax_task  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import surrogate as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import cascade  # noqa: E402
from repro_torch.core import supervisors as sup  # noqa: E402
from repro_torch.core import thresholds as thr  # noqa: E402
from repro_torch.data.synthetic import make_classification_task  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import surrogate as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


def carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------- weights

def test_params_from_jax_carries_bf16_leaves_bit_for_bit():
    cfg = dataclasses.replace(jax_get_config("yi-6b").reduced(),
                              dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jT.init_params(cfg, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, "cpu")
    wq = jp["blocks"]["attn"]["wq"]["w"]
    assert wq.dtype == ml_dtypes.bfloat16
    got = tp["blocks"]["attn"]["wq"]["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == wq.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))


def test_params_from_jax_keeps_tree_layout_and_recasts():
    jp = jax.tree.map(np.asarray, jS.init_params(
        jS.SurrogateConfig("s", 64, 8, 16, 2, 16, 4), jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, "cpu", dtype=torch.float64)
    assert isinstance(tp["blocks"], list) and set(tp) == set(jp)
    assert tuple(tp["hidden"]["w"].shape) == jp["hidden"]["w"].shape  # [in, out]
    assert all(x.dtype == torch.float64 for x in tree_leaves(tp))


def test_params_from_jax_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"a": np.zeros(2)})


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_configs_are_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())
    assert arch in list_archs()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_task_same_seed_same_task(seed):
    a = make_classification_task(seed, n=64, vocab=128, seq_len=12,
                                 num_classes=5)
    b = jax_task(seed, n=64, vocab=128, seq_len=12, num_classes=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_thresholds_are_copies():
    conf = np.random.default_rng(0).uniform(size=200)
    other = np.random.default_rng(1).uniform(size=100) * 0.5
    assert thr.nominal_quantile_threshold(conf, 0.05) == \
        jthr.nominal_quantile_threshold(conf, 0.05)
    assert thr.separation_threshold(conf, other) == \
        jthr.separation_threshold(conf, other)
    assert thr.escalation_rate_threshold(conf, 0.3) == \
        jthr.escalation_rate_threshold(conf, 0.3)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 64)])
def test_norms_match(shape):
    x, w, b = rnd(0, shape, 3.0), rnd(1, shape[-1:]), rnd(2, shape[-1:])
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
        jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), atol=1e-6)
    np.testing.assert_allclose(
        layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), 1e-5),
        jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           1e-5), atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope_rotates_halves_like_jax(theta):
    x = rnd(3, (2, 7, 4, 16))
    pos = np.arange(7)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("approx_input", [0.5, 3.0])
def test_mlps_match(approx_input):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 16)) * approx_input).astype(np.float32)
    gp = jlayers.gelu_mlp_params(jax.random.PRNGKey(0), 16, 24, jnp.float32)
    sp = jlayers.swiglu_params(jax.random.PRNGKey(1), 16, 24, jnp.float32)
    np.testing.assert_allclose(
        layers.gelu_mlp(carry(gp), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.gelu_mlp(gp, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        layers.swiglu(carry(sp), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.swiglu(sp, jnp.asarray(x))), atol=1e-5)


# ---------------------------------------------------------------- core

@pytest.mark.parametrize("name", sorted(jsup.SOFTMAX_SUPERVISORS))
@pytest.mark.parametrize("scale", [0.5, 5.0])
def test_softmax_supervisors_match(name, scale):
    x = rnd(5, (16, 10), scale)
    got = sup.SOFTMAX_SUPERVISORS[name](torch.from_numpy(x))
    want = jsup.SOFTMAX_SUPERVISORS[name](jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_select_escalations_ties_like_top_k(k):
    conf = np.array([0.5, 0.2, 0.9, 0.2, 0.2, 0.7, 0.5, 0.1, 0.2],
                    np.float32)
    idx, mask = cascade.select_escalations(torch.from_numpy(conf), k)
    jidx, jmask = jcascade.select_escalations(jnp.asarray(conf), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("rho", [0.0, 0.1, 0.3, 1.0])
def test_escalation_capacity_and_bisupervised(rho):
    assert cascade.escalation_capacity(32, rho) == \
        jcascade.escalation_capacity(32, rho)
    rng = np.random.default_rng(6)
    lp, rp = rng.integers(0, 4, 10), rng.integers(0, 4, 10)
    lc, rc = rng.uniform(size=10), rng.uniform(size=10)
    th = cascade.CascadeThresholds(0.5, rho)
    got = cascade.bisupervised_batch(*(torch.from_numpy(a)
                                       for a in (lp, lc, rp, rc)), th)
    want = jcascade.bisupervised_batch(
        *(jnp.asarray(a) for a in (lp, lc, rp, rc)),
        jcascade.CascadeThresholds(0.5, rho))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    idx = np.array([1, 4])
    np.testing.assert_array_equal(
        cascade.combine_escalated(torch.from_numpy(lp), torch.from_numpy(idx),
                                  torch.from_numpy(rp[:2])).numpy(),
        np.asarray(jcascade.combine_escalated(jnp.asarray(lp),
                                              jnp.asarray(idx),
                                              jnp.asarray(rp[:2]))))


# ---------------------------------------------------------------- surrogate

SCFG = dict(name="local", vocab_size=128, max_len=24, d_model=32,
            num_heads=2, d_ff=32, num_classes=8)


@pytest.mark.parametrize("pool,blocks", [("mean", 1), ("first", 2)])
def test_surrogate_logits_match(pool, blocks):
    jcfg = jS.SurrogateConfig(**SCFG, pool=pool, num_blocks=blocks)
    tcfg = S.SurrogateConfig(**SCFG, pool=pool, num_blocks=blocks)
    jp = jS.init_params(jcfg, jax.random.PRNGKey(2))
    toks = np.random.default_rng(8).integers(0, 128, (6, 24)).astype(np.int32)
    toks[0, 10:] = 0                                   # padded row
    jl, jh = jS.apply(jcfg, jp, jnp.asarray(toks), return_hidden=True)
    tl, th = S.apply(tcfg, carry(jp), torch.from_numpy(toks),
                     return_hidden=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-5)
    labels = np.arange(6) % 8
    jloss, _ = jS.loss_fn(jcfg.__class__(**{**SCFG, "pool": pool,
                                            "num_blocks": blocks,
                                            "dropout": 0.0}),
                          jp, jnp.asarray(toks), jnp.asarray(labels),
                          jax.random.PRNGKey(0))
    tloss, _ = S.loss_fn(S.SurrogateConfig(**SCFG, pool=pool,
                                           num_blocks=blocks, dropout=0.0),
                         carry(jp), torch.from_numpy(toks),
                         torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)


def test_surrogate_mc_dropout_uses_the_generator():
    """Dropout masks come from an explicit generator: the same seed gives
    the same sample, another seed another one (the masks differ from
    JAX's, so the two packages are compared on dropout-free paths)."""
    cfg = S.SurrogateConfig(**SCFG, dropout=0.2)
    params = S.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, 128, (4, 24)))

    def sample(seed):
        return S.apply(cfg, params, toks, mc_dropout=True,
                       dropout_rng=torch.Generator().manual_seed(seed))

    assert torch.equal(sample(1), sample(1))
    assert not torch.equal(sample(1), sample(2))
    with pytest.raises(ValueError, match="dropout_rng"):
        S.apply(cfg, params, toks, mc_dropout=True)
    # inverted dropout keeps the expected activation: the mean kept
    # fraction of one layer's mask is 1 - rate
    x = torch.ones(200_000)
    kept = (S._dropout(x, 0.2, torch.Generator().manual_seed(4)) > 0)
    assert abs(float(kept.float().mean()) - 0.8) < 0.01


# ---------------------------------------------------------------- remote

def test_reduced_yi6b_prefill_logits_and_kv_match():
    cfg = jax_get_config("yi-6b").reduced()
    jp = jT.init_params(cfg, jax.random.PRNGKey(7))
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, (3, 20))
    jl, jc = jT.prefill(cfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(get_config("yi-6b").reduced(), carry(jp),
                           {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        assert tuple(tc["main"][key].shape) == jc["main"][key].shape
        np.testing.assert_allclose(tc["main"][key].numpy(),
                                   np.asarray(jc["main"][key]), atol=1e-4)


def test_reduced_forward_hidden_matches():
    cfg = jax_get_config("yi-6b").reduced()
    jp = jT.init_params(cfg, jax.random.PRNGKey(1))
    toks = np.random.default_rng(11).integers(1, cfg.vocab_size, (2, 16))
    jx, _ = jT.forward(cfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tx, _ = T.forward(get_config("yi-6b").reduced(), carry(jp),
                          {"tokens": toks})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)


def test_init_params_layout_matches_jax():
    cfg = get_config("yi-6b").reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jT.init_params(jax_get_config("yi-6b").reduced(),
                        jax.random.PRNGKey(0))
    shapes = tree_map(lambda a: tuple(a.shape), tp)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jshapes


@pytest.mark.parametrize("arch", ["pixtral-12b", "zamba2-7b",
                                  "hubert-xlarge"])
def test_unported_families_raise(arch):
    """The last three families are ported: each builds JAX's parameter
    tree, and raises only where JAX refuses too (hubert's decode, and a
    token prompt to a model without a token embedding) or on an input of
    no family (a [B, 1, D] decode input)."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(params) >= {"final_norm", "head", "blocks"}
    assert ("embed" in params) == (arch != "hubert-xlarge")
    cache = T.make_cache(cfg, 1, 4, "cpu")
    if arch == "hubert-xlarge":
        with pytest.raises(ValueError, match="encoder-only"):
            T.decode_step(cfg, params, torch.zeros(1, dtype=torch.long),
                          cache, 0)
        with pytest.raises(ValueError, match="'embeds'"):
            T.prefill(cfg, params, {"tokens": np.ones((1, 4), np.int32)})
    else:
        with pytest.raises(ValueError, match="embedding"):
            T.decode_step(cfg, params, torch.zeros(1, 1, cfg.d_model),
                          cache, 0)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("step", [0, 3, 50, 9_999])
def test_lr_schedule_matches(step):
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    assert abs(opt.lr_schedule(cfg, step)
               - float(jopt.lr_schedule(jcfg, step))) < 1e-9


def test_adamw_steps_match():
    jp = jS.init_params(jS.SurrogateConfig(**SCFG), jax.random.PRNGKey(4))
    grads = jax.tree.map(lambda a: jnp.asarray(
        rnd(a.size, a.shape, 0.1)), jp)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=1)
    tcfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1)
    js, ts = jopt.init_opt_state(jp), opt.init_opt_state(carry(jp))
    tp, tg = carry(jp), carry(grads)
    for _ in range(3):
        jp, js, _ = jopt.adamw_update(jcfg, jp, grads, js)
        tp, ts, _ = opt.adamw_update(tcfg, tp, tg, ts)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert ts["step"] == int(js["step"])
