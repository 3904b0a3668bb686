"""The generate path of the PyTorch port against the JAX package: the
sequence reducers, ``make_cache``, ``decode_step`` and ``greedy_generate``
on reduced yi-6b (plain GQA cache) and reduced h2o-danube (sliding-window
ring buffer; prompt 96 > window 64), with JAX's parameters carried over by
``params_from_jax``. The port runs on the CPU (the kernels' plain
versions).

Tolerances: decode logits and caches 1e-4 (two layers of f32 matmuls of
width 256-512 summed in another order, as for the prefill); generated
tokens exact, after asserting that every step's top-2 logit gap exceeds
1e-4, so the argmax is decided by more than the packages' difference;
likelihoods 1e-5 (a max-softmax of those logits); reducers 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import supervisors as jsup  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import supervisors as sup  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.serving.generate import graft  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCHS = {"yi-6b": 32, "h2o-danube-1.8b": 96}     # arch -> prompt length
GAP = 1e-4


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch = request.param
    jcfg = jax_get_config(arch).reduced()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return dict(arch=arch, jcfg=jcfg, jp=jp, cfg=get_config(arch).reduced(),
                tp=tp, t=ARCHS[arch])


def graft_jax(cache, pcache):
    def cp(d, s):
        if d.shape == s.shape:
            return s
        return jax.lax.dynamic_update_slice_in_dim(d, s, 0, axis=2)
    return jax.tree.map(cp, cache, pcache)


@torch.no_grad()
def teacher_forced_logits(cfg, params, prompt, forced):
    """The port's logits at each step when ``forced`` [B, N] is fed after
    the prompt: the prefill's, then N - 1 decode steps'."""
    b, t = prompt.shape
    logits, pcache = T.prefill(cfg, params, {"tokens": prompt})
    cache = graft(T.make_cache(cfg, b, t + forced.shape[1], "cpu"), pcache)
    out = [logits]
    for i in range(forced.shape[1] - 1):
        logits, cache = T.decode_step(cfg, params, forced[:, i], cache, t + i)
        out.append(logits)
    return out


def top2_gap(logits: torch.Tensor) -> float:
    top = torch.topk(logits, 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


# ------------------------------------------------------------- reducers

@pytest.mark.parametrize("masked", [False, True])
def test_sequence_reducers_match(masked):
    rng = np.random.default_rng(4)
    lk = rng.uniform(0.0, 1.0, (6, 9)).astype(np.float32)
    lk[0, 3] = 0.0                                  # clipped by the product
    mask = (rng.uniform(size=(6, 9)) > 0.3).astype(np.float32) if masked \
        else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    for name in ("seq_min_likelihood", "seq_prod_likelihood"):
        got = getattr(sup, name)(torch.from_numpy(lk), tm).numpy()
        want = np.asarray(getattr(jsup, name)(jnp.asarray(lk), jm))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


# ------------------------------------------------------------ the cache

def test_make_cache_matches_jax(model):
    for max_len in (40, 100, 200):
        tc = T.make_cache(model["cfg"], 3, max_len, "cpu")
        jc = jT.make_cache(model["jcfg"], 3, max_len)
        assert set(tc) == set(jc) == {"main"}
        for key in ("k", "v"):
            assert tuple(tc["main"][key].shape) == jc["main"][key].shape
            assert tc["main"][key].dtype == torch.float32
            assert not tc["main"][key].any()


def test_make_kv_cache_ring_buffer_holds_only_the_window():
    cfg = get_config("h2o-danube-1.8b").reduced()
    cache = layers.make_kv_cache(cfg, 2, 500, torch.float32, device="cpu")
    assert cache["k"].shape[2] == cfg.sliding_window == 64


@pytest.mark.parametrize("pos_on_device", [False, True])
def test_decode_step_matches_jax_teacher_forced(model, pos_on_device):
    """Prefill, then decode a fixed token sequence (wrapping the ring
    buffer under SWA); logits and caches after every step match JAX,
    with the position a host int or a 0-d tensor (the graph path's)."""
    cfg, jcfg, t = model["cfg"], model["jcfg"], model["t"]
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, cfg.vocab_size, (2, t)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    _, jpc = jT.prefill(jcfg, model["jp"], {"tokens": jnp.asarray(prompt)})
    jc = graft_jax(jT.make_cache(jcfg, 2, t + 8), jpc)
    with torch.no_grad():
        _, tpc = T.prefill(cfg, model["tp"], {"tokens": prompt})
        tc = graft(T.make_cache(cfg, 2, t + 8, "cpu"), tpc)
        for i in range(forced.shape[1]):
            jl, jc = jT.decode_step(jcfg, model["jp"],
                                    jnp.asarray(forced[:, i]), jc,
                                    jnp.int32(t + i))
            pos = torch.tensor(t + i) if pos_on_device else t + i
            tl, tc2 = T.decode_step(cfg, model["tp"],
                                    torch.from_numpy(forced[:, i]), tc, pos)
            assert tc2 is tc                       # updated in place
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
            for key in ("k", "v"):
                np.testing.assert_allclose(tc["main"][key].numpy(),
                                           np.asarray(jc["main"][key]),
                                           atol=1e-4, err_msg=key)


# the families whose decode loop the graph path takes (one dense or
# sliding-window GQA stack, no MoE layer), with a prompt length: h2o's
# 96 lies past its window of 64, so its ring wraps before decoding
GRAPH_FAMILIES = {"yi-6b": 8, "qwen2-7b": 8, "h2o-danube-1.8b": 96,
                  "deepseek-67b": 8, "pixtral-12b": 8}


@pytest.mark.parametrize("arch", sorted(GRAPH_FAMILIES))
def test_decode_step_takes_its_position_as_a_tensor(arch):
    """``decode_step`` with ``pos`` a 0-d tensor (read on the device, as
    a CUDA graph of the step reads it) gives the host-int form's logits
    and cache bit for bit, step after step (under SWA around the ring
    and past it)."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    t, steps = GRAPH_FAMILIES[arch], 70
    prompt = torch.randint(1, cfg.vocab_size, (2, t),
                           generator=torch.Generator().manual_seed(1))
    caches = []
    with torch.no_grad():
        for _ in range(2):
            logits, pcache = T.prefill(cfg, params, {"tokens": prompt})
            caches.append(graft(T.make_cache(cfg, 2, t + steps, "cpu"),
                                pcache))
        tok = logits.argmax(-1)
        for i in range(steps):
            by_int, _ = T.decode_step(cfg, params, tok, caches[0], t + i)
            by_tensor, _ = T.decode_step(cfg, params, tok, caches[1],
                                         torch.tensor(t + i))
            assert torch.equal(by_int, by_tensor), i
            tok = by_int.argmax(-1)
    for key in ("k", "v"):
        assert torch.equal(caches[0]["main"][key], caches[1]["main"][key])


def test_decode_matches_prefill(model):
    """Decoding the last token after a prefill of the others gives the
    logits of a prefill over all of them (mirrors the JAX package's
    test_decode_matches_prefill)."""
    cfg, params = model["cfg"], model["tp"]
    t = 96
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, t))
    with torch.no_grad():
        want, _ = T.prefill(cfg, params, {"tokens": toks})
        logits, pcache = T.prefill(cfg, params, {"tokens": toks[:, :-1]})
        cache = graft(T.make_cache(cfg, 2, t + 4, "cpu"), pcache)
        got, _ = T.decode_step(cfg, params, toks[:, -1], cache, t - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------- generation

def test_greedy_generate_matches_jax(model):
    cfg, t, n = model["cfg"], model["t"], 6
    prompt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, t)).astype(np.int32)
    toks, liks = greedy_generate(cfg, model["tp"], {"tokens": prompt}, n)
    assert toks.shape == liks.shape == (2, n)
    assert toks.dtype == torch.int32 and liks.dtype == torch.float32
    gaps = [top2_gap(lg) for lg in teacher_forced_logits(
        cfg, model["tp"], torch.from_numpy(prompt), toks)]
    assert min(gaps) > GAP, f"inputs: a top-2 logit gap of {min(gaps)}"
    jtoks, jliks = jax_generate(model["jcfg"], model["jp"],
                                {"tokens": jnp.asarray(prompt)}, n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(liks.numpy(), np.asarray(jliks), atol=1e-5)


def test_greedy_generate_is_self_consistent(model):
    """Token i chosen by the decode loop == argmax of a fresh prefill over
    prompt + tokens[:i] (mirrors the JAX package's test)."""
    cfg, params = model["cfg"], model["tp"]
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 32))
    toks, liks = greedy_generate(cfg, params, {"tokens": prompt},
                                 max_new_tokens=4)
    assert toks.shape == (1, 4) and liks.shape == (1, 4)
    assert bool(((liks > 0) & (liks <= 1)).all())
    seq = torch.from_numpy(prompt)
    with torch.no_grad():
        for i in range(4):
            logits, _ = T.prefill(cfg, params, {"tokens": seq})
            assert int(logits.argmax(-1)[0]) == int(toks[0, i]), i
            seq = torch.cat([seq, toks[:, i:i + 1].long()], dim=1)


def test_min_likelihood_reduces_generated_answers(model):
    """The 2nd supervisor over generated answers: seq_min_likelihood of
    the port's likelihoods equals JAX's over JAX's."""
    cfg, t = model["cfg"], model["t"]
    prompt = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (3, t)).astype(np.int32)
    _, liks = greedy_generate(cfg, model["tp"], {"tokens": prompt}, 3)
    _, jliks = jax_generate(model["jcfg"], model["jp"],
                            {"tokens": jnp.asarray(prompt)}, 3)
    np.testing.assert_allclose(sup.seq_min_likelihood(liks).numpy(),
                               np.asarray(jsup.seq_min_likelihood(jliks)),
                               atol=1e-5)


def test_decode_step_refuses_embeddings_and_other_families():
    """``decode_step`` takes a [B] token or a [B, D] embedding (as JAX's
    does; the embedding of a token decodes as the token) and refuses any
    other input, and the encoder (hubert) refuses to decode at all."""
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.tensor([3, 7])
    with torch.no_grad():
        by_token, _ = T.decode_step(cfg, params, tok,
                                    T.make_cache(cfg, 2, 8, "cpu"), 0)
        by_embed, _ = T.decode_step(cfg, params, params["embed"][tok],
                                    T.make_cache(cfg, 2, 8, "cpu"), 0)
    assert torch.equal(by_token, by_embed)
    with pytest.raises(ValueError, match="embedding"):
        T.decode_step(cfg, params, torch.zeros(2, 1, cfg.d_model),
                      T.make_cache(cfg, 2, 8, "cpu"), 0)
    enc = get_config("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step(enc, T.init_params(enc, torch.Generator()), tok,
                      T.make_cache(enc, 2, 8, "cpu"), 0)


# ------------------------------------------------- the decode loop's path

# every arch that decodes -> whether its decode loop can be a CUDA graph
TAKES_THE_GRAPH = {"yi-6b": True, "qwen2-7b": True, "h2o-danube-1.8b": True,
                   "deepseek-67b": True, "pixtral-12b": True,
                   "rwkv6-1.6b": False, "zamba2-7b": False,
                   "deepseek-v2-lite-16b": False,     # MLA, MoE
                   "qwen3-moe-235b-a22b": False}      # GQA, MoE


@pytest.mark.parametrize("arch", sorted(TAKES_THE_GRAPH))
def test_graph_path_takes_one_gqa_stack_without_moe(arch):
    """The path selector on the cache and parameters' structure: RWKV6's
    and zamba2's states, MLA's latents and an MoE layer go to the eager
    loop (checked on fake tensors of the full parameter tree)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.serving import generate
    cfg = get_config(arch).reduced()
    params = sh.eval_shape(
        lambda: T.init_params(cfg, torch.Generator().manual_seed(0)))
    cache = sh.eval_shape(lambda: T.make_cache(cfg, 2, 8, "cpu"))
    assert generate._gqa_stack(params, cache) is TAKES_THE_GRAPH[arch]


def test_graph_path_needs_real_unsharded_cuda_tensors():
    """CPU tensors, fake CUDA tensors (the dry-run's kind) and DTensors
    go to the eager loop, and so does a GQA model's CPU prefill."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.serving import generate
    fake = sh.eval_shape(lambda: torch.zeros(2, device="cuda"))
    assert fake.is_cuda and not generate._on_card(fake)
    assert not generate._on_card(torch.zeros(2))
    assert not dist.is_initialized()
    try:
        mesh = device_mesh(Mesh({"data": 1, "model": 1}), "gloo")
        sharded = DTensor.from_local(torch.zeros(2), mesh.device_mesh,
                                     [Replicate(), Replicate()])
        assert not generate._on_card(sharded)
    finally:
        dist.destroy_process_group()
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, pcache = T.prefill(cfg, params, {"tokens": torch.ones(
            (2, 4), dtype=torch.int32)})
    assert generate._gqa_stack(params, pcache)
    assert not generate._graphable(params, logits, pcache)


class _Bookkept:
    """``DecodeGraph``'s place in ``GRAPHS`` without its CUDA buffers:
    what ``decode_graph`` keeps and drops."""

    def __init__(self, cfg, batch, max_len, device):
        self.release = None


@pytest.fixture
def bookkept(monkeypatch):
    """``decode_graph`` over an empty ``GRAPHS`` of ``_Bookkept``."""
    from collections import OrderedDict
    from repro_torch.serving import generate
    monkeypatch.setattr(generate, "DecodeGraph", _Bookkept)
    monkeypatch.setattr(generate, "GRAPHS", OrderedDict())
    return generate, get_config("yi-6b").reduced()


def test_decode_graph_keeps_the_last_keys(bookkept):
    """A key's second lookup is a hit; other parameters' storage is
    another key; past ``MAX_GRAPHS`` keys the least recently used goes,
    its release detached."""
    generate, cfg = bookkept
    dev = torch.device("cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    other = {**params, "final_norm": params["final_norm"].clone()}
    first = generate.decode_graph(cfg, params, 2, 8, dev)
    theirs = generate.decode_graph(cfg, other, 2, 8, dev)
    assert theirs is not first
    assert generate.decode_graph(cfg, params, 2, 8, dev) is first
    made = [generate.decode_graph(cfg, params, 2, n, dev) for n in (9, 10)]
    assert len(generate.GRAPHS) == generate.MAX_GRAPHS == 4
    made.append(generate.decode_graph(cfg, params, 2, 11, dev))
    assert list(generate.GRAPHS.values()) == [first, *made]
    assert not theirs.release.alive and first.release.alive


def test_decode_graphs_go_with_their_parameters_or_on_release(bookkept):
    """Freeing the parameters drops their graphs, whatever their other
    keys; ``release_graphs`` drops every graph."""
    import gc
    generate, cfg = bookkept
    dev = torch.device("cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    other = T.init_params(cfg, torch.Generator().manual_seed(1))
    for n in (8, 9):
        generate.decode_graph(cfg, params, 2, n, dev)
    theirs = generate.decode_graph(cfg, other, 2, 8, dev)
    assert len(generate.GRAPHS) == 3
    del params
    gc.collect()
    assert list(generate.GRAPHS.values()) == [theirs]
    generate.release_graphs()
    assert not generate.GRAPHS and not theirs.release.alive
