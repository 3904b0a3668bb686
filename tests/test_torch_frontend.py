"""The frontend archs in the PyTorch port against the JAX package: pixtral-12b
(a VLM: patch embeddings, then text tokens) and hubert-xlarge (an audio
encoder on frame embeddings, no token embedding), reduced, with JAX's
parameters carried over by ``params_from_jax`` and the embeddings, tokens
and labels from numpy seeds (the frontend stubs draw from
``jax.random`` and a ``torch.Generator``, whose bits differ). The port
runs on the CPU.

Also pinned here, both packages' results side by side, are two places where
the reference disagrees with itself (ROADMAP C.3, C.4): JAX's
``greedy_generate`` on a prompt of embeddings and tokens starts decoding
at the tokens' length, over the patch prefix's cache slots, where the
port starts after the whole prompt; and ``prefill`` is causal for the
encoder, as JAX's is, though ``forward`` is bidirectional there.

Tolerances (all fp32): logits, hidden states and caches 1e-4 (two layers
of f32 matmuls, as for yi-6b); tokens, labels and generated tokens exact
(after checking every step's top-2 logit gap); loss rtol 1e-5 and every
gradient leaf within 1e-4 * max|g| + 1e-7.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import frontend as jfront  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.serving.generate import graft  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import jax_leaves, tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from tests.test_torch_generate import graft_jax, top2_gap  # noqa: E402

VLM, AUDIO = "pixtral-12b", "hubert-xlarge"
GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@functools.cache
def load(arch: str) -> dict:
    """JAX's reduced parameters of ``arch``, carried into the port, and
    JAX's prefill, compiled once per process."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(1))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, tp=carry(jp),
                prefill=jax.jit(lambda p, b: jT.prefill(jcfg, p, b)))


def inputs(cfg, seed: int, b: int, t_img: int, t_txt: int):
    """Numpy embeddings [b, t_img, D] and tokens [b, t_txt] (either may be
    empty: 0 leaves it out)."""
    rng = np.random.default_rng(seed)
    out = {}
    if t_img:
        out["embeds"] = rng.standard_normal(
            (b, t_img, cfg.d_model)).astype(np.float32)
    if t_txt:
        out["tokens"] = rng.integers(1, cfg.vocab_size,
                                     (b, t_txt)).astype(np.int32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ init

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_init_params_tree_shapes_and_dtypes_match_jax(arch, dtype):
    """pixtral keeps a token embedding, hubert has none (and a head of
    num_classes)."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jp = jax.eval_shape(lambda: jT.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                    tp) == jax.tree.map(lambda a: (tuple(a.shape),
                                                   str(a.dtype)), jp)
    assert ("embed" in tp) == (arch == VLM) == T.takes_tokens(cfg)


# --------------------------------------------------------- frontend stub

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_frontend_embeddings_shape_dtype_and_determinism(arch):
    cfg = get_config(arch)
    a = frontend.frontend_embeddings(cfg, 2, 5, seed=3, device="cpu")
    b = frontend.frontend_embeddings(cfg, 2, 5, seed=3, device="cpu")
    c = frontend.frontend_embeddings(cfg, 2, 5, seed=4, device="cpu")
    want = jfront.frontend_embeddings(jax_get_config(arch), 2, 5, seed=3)
    assert tuple(a.shape) == want.shape == (2, 5, cfg.d_model)
    assert str(a.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"
    assert torch.equal(a, b) and not torch.equal(a, c)
    # standard normal draws, as JAX's
    assert abs(float(a.float().mean())) < 0.1
    assert 0.9 < float(a.float().std()) < 1.1


def test_frontend_embeddings_refuse_a_token_arch_as_jax_does():
    with pytest.raises(AssertionError):
        jfront.frontend_embeddings(jax_get_config("yi-6b"), 1, 2)
    with pytest.raises(ValueError, match="takes no frontend"):
        frontend.frontend_embeddings(get_config("yi-6b"), 1, 2, device="cpu")


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_make_batches_tokens_and_labels_match_jax(arch):
    """The tokens (VLM) and labels (encoder) are JAX's to the bit; the
    embeddings have JAX's shape and dtype and are the same in every
    batch, as JAX's are."""
    mine = launch.make_batches(get_config(arch).reduced(), 3, 32, seed=5)
    theirs = jlaunch.make_batches(jax_get_config(arch).reduced(), 3, 32,
                                  seed=5)
    first = None
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert set(a) == set(b)
        for key in set(a) - {"embeds"}:
            assert a[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
        assert tuple(a["embeds"].shape) == b["embeds"].shape
        assert str(a["embeds"].dtype).split(".")[-1] == \
            str(b["embeds"].dtype)
        first = a["embeds"] if first is None else first
        assert torch.equal(a["embeds"], first)
    if arch == VLM:
        assert a["embeds"].shape[1] == a["tokens"].shape[1] == 16
    else:
        assert a["labels"].shape == (3, 32)


# ------------------------------------------------------ prefill, forward

@pytest.mark.parametrize("arch,parts", [
    (VLM, (16, 0)), (VLM, (0, 16)), (VLM, (8, 8)), (AUDIO, (16, 0))],
    ids=["vlm-embeds", "vlm-tokens", "vlm-both", "audio-embeds"])
def test_prefill_matches_jax(arch, parts):
    model = load(arch)
    cfg = model["cfg"]
    batch = inputs(cfg, 10, 3, *parts)
    jl, jc = model["prefill"](model["jp"], jax_batch(batch))
    with torch.no_grad():
        tl, tc = T.prefill(cfg, model["tp"], batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert tuple(tc["main"]["k"].shape)[2] == sum(parts)
    for got, want in zip(jax_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_jax(arch):
    model = load(arch)
    cfg = model["cfg"]
    parts = (8, 8) if model["arch"] == VLM else (16, 0)
    batch = inputs(cfg, 11, 2, *parts)
    jx, _ = jT.forward(model["jcfg"], model["jp"], jax_batch(batch))
    with torch.no_grad():
        tx, _ = T.forward(cfg, model["tp"], batch)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)


def test_encoder_prefill_is_causal_as_jax_forward_is_not():
    """ROADMAP C.4: JAX's ``prefill`` runs causal attention for the
    encoder too, and its ``forward`` bidirectional attention, so the two
    last-position logits differ; the port keeps both behaviours. Each
    package's pair differs by more than 1e-2, and the packages agree on
    each within 1e-4."""
    model = load(AUDIO)
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = inputs(cfg, 12, 1, 16, 0)
    jl, _ = model["prefill"](model["jp"], jax_batch(batch))
    jx, _ = jT.forward(jcfg, model["jp"], jax_batch(batch))
    jf = jT.dense(model["jp"]["head"], jx[:, -1])
    with torch.no_grad():
        tl, _ = T.prefill(cfg, model["tp"], batch)
        tx, _ = T.forward(cfg, model["tp"], batch)
        tf = T.dense(model["tp"]["head"], tx[:, -1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4)
    assert float(np.abs(np.asarray(jl) - np.asarray(jf)).max()) > 1e-2
    assert float((tl - tf).abs().max()) > 1e-2


def test_encoder_refuses_decode_and_tokens():
    model = load(AUDIO)
    cfg = model["cfg"]
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step(cfg, model["tp"], np.zeros(1, np.int32),
                      T.make_cache(cfg, 1, 4, "cpu"), 0)
    with pytest.raises(ValueError, match="'embeds'"):
        T.prefill(cfg, model["tp"], inputs(cfg, 1, 1, 0, 4))
    with pytest.raises(AssertionError):
        jT.prefill(model["jcfg"], model["jp"],
                   jax_batch(inputs(cfg, 1, 1, 0, 4)))


# ------------------------------------------------------------- decode

def test_vlm_decode_step_on_embeddings_matches_jax():
    """After a prefill of embeddings and tokens, ``decode_step`` on [B, D]
    embeddings and then on [B] tokens: logits after every step and every
    cache leaf at the end as JAX's."""
    model = load(VLM)
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = inputs(cfg, 13, 2, 8, 8)
    t = 16
    steps = np.random.default_rng(14).standard_normal(
        (3, 2, cfg.d_model)).astype(np.float32)
    toks = np.random.default_rng(15).integers(1, cfg.vocab_size, (2, 2))
    feed = list(steps) + [toks[:, i].astype(np.int32) for i in range(2)]
    _, jpc = model["prefill"](model["jp"], jax_batch(batch))
    jc = graft_jax(jT.make_cache(jcfg, 2, t + len(feed)), jpc)
    jdecode = jax.jit(lambda p, tok, c, pos: jT.decode_step(jcfg, p, tok, c,
                                                            pos))
    with torch.no_grad():
        _, tpc = T.prefill(cfg, model["tp"], batch)
        tc = graft(T.make_cache(cfg, 2, t + len(feed), "cpu"), tpc)
        for i, x in enumerate(feed):
            jl, jc = jdecode(model["jp"], jnp.asarray(x), jc, jnp.int32(t + i))
            tl, tc = T.decode_step(cfg, model["tp"], x, tc, t + i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for got, want in zip(jax_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="embedding"):
        T.decode_step(cfg, model["tp"], np.zeros((2, 1, 3), np.float32), tc,
                      t)


# ----------------------------------------------------------- generate

def fresh_prefill_tokens(prefill_fn, batch, toks):
    """The argmax of a fresh prefill over the prompt and toks[:, :i], for
    each step i."""
    out, seq = [], dict(batch)
    tail = np.zeros((toks.shape[0], 0), np.int32)
    for i in range(toks.shape[1]):
        seq["tokens"] = np.concatenate([batch["tokens"], tail], 1) \
            if "tokens" in batch else tail
        if not seq["tokens"].shape[1]:
            del seq["tokens"]
        out.append(np.asarray(prefill_fn(seq)).argmax(-1))
        tail = np.concatenate([tail, toks[:, i:i + 1]], 1).astype(np.int32)
    return np.stack(out, 1)


def test_vlm_generation_decodes_after_the_whole_prompt():
    """ROADMAP C.3, on the inputs it was found with: reduced pixtral from
    ``PRNGKey(1)``, 8 patch embeddings then 8 tokens from numpy seed 0,
    12 new tokens. The port's tokens are at every step what a fresh
    prefill over the prompt and the tokens before picks; JAX's agree at
    the first step and not at the second (it decodes from position 8,
    over the patch prefix's slots)."""
    model = load(VLM)
    jcfg, cfg, jp, tp = model["jcfg"], model["cfg"], model["jp"], model["tp"]
    batch = inputs(cfg, 0, 1, 8, 8)
    n = 12
    toks, _ = greedy_generate(cfg, tp, batch, n)
    toks = toks.numpy()
    with torch.no_grad():
        fresh = fresh_prefill_tokens(
            lambda b: T.prefill(cfg, tp, b)[0].numpy(), batch, toks)
    np.testing.assert_array_equal(toks, fresh)
    jtoks, _ = jax_generate(jcfg, jp, jax_batch(batch), n)
    jtoks = np.asarray(jtoks)
    jfresh = fresh_prefill_tokens(
        lambda b: model["prefill"](jp, jax_batch(b))[0], batch, jtoks)
    assert jtoks[0, 0] == jfresh[0, 0] == toks[0, 0] == 351
    assert (jtoks[0, 1], jfresh[0, 1]) == (286, 251)
    assert toks[0, 1] == 251


@pytest.mark.parametrize("parts", [(0, 12), (12, 0)],
                         ids=["tokens", "embeds"])
def test_vlm_generation_matches_jax_on_one_kind_of_prompt(parts):
    """A prompt of tokens only or of embeddings only: both packages decode
    from its length, token for token."""
    model = load(VLM)
    jcfg, cfg, jp, tp = model["jcfg"], model["cfg"], model["jp"], model["tp"]
    batch = inputs(cfg, 16, 2, *parts)
    n = 6
    toks, liks = greedy_generate(cfg, tp, batch, n)
    # every step's argmax decided by more than the packages' difference
    with torch.no_grad():
        lg, pc = T.prefill(cfg, tp, batch)
        t = sum(parts)
        cache = graft(T.make_cache(cfg, 2, t + n, "cpu"), pc)
        gaps = [top2_gap(lg)]
        for i in range(n - 1):
            lg, cache = T.decode_step(cfg, tp, toks[:, i], cache, t + i)
            gaps.append(top2_gap(lg))
    assert min(gaps) > GAP, f"inputs: a top-2 logit gap of {min(gaps)}"
    jtoks, jliks = jax_generate(jcfg, jp, jax_batch(batch), n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(liks.numpy(), np.asarray(jliks), atol=1e-5)


# ------------------------------------------------------ loss, gradients

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """The VLM's next-token loss over the text region only (the patch
    prefix carries no label), and the encoder's per-frame loss on labels
    with a mask; ``loss_fn`` and every gradient leaf."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.jit(jT.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(7))
    if arch == VLM:
        batch = inputs(cfg, 17, 2, 12, 20)
    else:
        batch = inputs(cfg, 17, 2, 32, 0)
        rng = np.random.default_rng(18)
        batch["labels"] = rng.integers(0, cfg.num_classes,
                                       (2, 32)).astype(np.int32)
        batch["mask"] = (rng.random((2, 32)) > 0.25).astype(np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(jcfg, p, jax_batch(batch)), has_aux=True))(jp)
    tl, tm, tg = loop.value_and_grad(cfg, carry(jp), batch)
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
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


def test_vlm_loss_ignores_the_patch_prefix_labels():
    """Changing the embeddings' positions' would-be labels cannot move the
    VLM loss: only text positions carry labels, so a batch with twice
    the patches has as many labelled positions (the accuracy's
    denominator) as the tokens minus one, per row."""
    cfg = get_config(VLM).reduced()
    labels, mask = T._labels_and_mask(cfg, inputs(cfg, 19, 2, 6, 10),
                                      torch.device("cpu"))
    assert tuple(labels.shape) == tuple(mask.shape) == (2, 16)
    assert not bool(mask[:, :6].any()) and not bool(labels[:, :6].any())
    assert float(mask.sum()) == 2 * 9 and float(mask[:, -1].sum()) == 0


# --------------------------------------------------------------- launch

def test_train_launcher_runs_hubert_on_the_cpu(capsys):
    assert launch.main(["--device", "cpu", "--smoke", "--arch", AUDIO,
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "hubert-xlarge-smoke" in out and "step     2" in out


def test_serve_main_runs_pixtral_remote_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--remote-arch", VLM,
                       "--requests", "32", "--batch", "16"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 32 requests" in out and "remote tier pixtral-12b-smoke" \
        in out


def test_serve_refuses_the_encoder_as_remote_tier(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--smoke", "--remote-arch",
                          AUDIO])
    assert "no token embedding" in capsys.readouterr().err
