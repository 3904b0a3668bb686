"""Checkpoints, the tokenizer, the batch iterator and the launcher's batch
stream of the port against the JAX package.

A checkpoint either package writes loads in the other bit for bit
(bfloat16 leaves included) with its step; the port writes leaves in
``jax.tree.flatten`` order and JAX's treedef string. The tokenizer's
``hash()`` is salted per process, so the two tokenizers are compared in
this one. Data comes from numpy seeds and must match exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import tokenizer as jtok  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import BatchIterator, HashTokenizer, reduce_domain  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.tree import (jax_leaves, jax_treedef, jax_unflatten,  # noqa: E402
                              tree_leaves, tree_map)
from repro_torch.weights import opt_state_from_jax, params_from_jax  # noqa: E402


def bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as int16), from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request):
    """Reduced rwkv6 (nested dicts) parameters and a JAX AdamW state after
    one step on random gradients, in ``request.param``."""
    cfg = dataclasses.replace(jax_get_config("rwkv6-1.6b").reduced(),
                              dtype=request.param)
    jp = jT.init_params(cfg, jax.random.PRNGKey(5))
    grads = jax.tree.map(lambda a: jnp.asarray(
        np.random.default_rng(a.size).standard_normal(a.shape), a.dtype), jp)
    jp, js, _ = jax.jit(lambda p, g, s: jopt.adamw_update(
        jopt.AdamWConfig(), p, g, s))(jp, grads, jopt.init_opt_state(jp))
    return jp, js


def test_port_checkpoint_loads_in_jax(trained, tmp_path):
    jp, js = trained
    tree = (params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
    path = str(tmp_path / "port.msgpack")
    ck.save_checkpoint(path, tree, step=17)
    (rp, rs), step = jck.load_checkpoint(path, (jp, js))
    assert step == 17
    for want, got in zip(jax.tree.leaves((jp, js)),
                         jax.tree.leaves((rp, rs))):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(bits(got), bits(want))
    assert int(rs["step"]) == 1


def test_jax_checkpoint_loads_in_the_port(trained, tmp_path):
    jp, js = trained
    path = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(path, (jp, js), step=23)
    like = (params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            opt.init_opt_state(params_from_jax(
                jax.tree.map(np.asarray, jp), "cpu")))
    (tp, ts), step = ck.load_checkpoint(path, like)
    assert step == 23 and ts["step"] == 1
    assert isinstance(tp["blocks"]["maa"], dict)
    for want, got in zip(jax.tree.leaves((jp, js["m"], js["v"])),
                         jax_leaves((tp, ts["m"], ts["v"]))):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == want.dtype.name
        np.testing.assert_array_equal(bits(got), bits(want))


def test_port_checkpoint_round_trip_and_treedef(trained, tmp_path):
    jp, js = trained
    tree = (params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
    assert jax_treedef(tree) == str(jax.tree.flatten((jp, js))[1])
    path = str(tmp_path / "rt.msgpack")
    ck.save_checkpoint(path, tree, step=3)
    back, step = ck.load_checkpoint(path, tree)
    assert step == 3 and back[1]["step"] == tree[1]["step"]
    assert list(back[0]) == list(tree[0])      # insertion order kept
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        if isinstance(b, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "hubert-xlarge"])
def test_family_trees_carry_and_checkpoint_both_ways(arch, tmp_path):
    """zamba2's tree (stacked ``blocks.norm``/``blocks.mixer.*``, the
    unstacked ``shared_attn``) and hubert's (no ``embed``), parameters
    and a JAX AdamW state after one step: carried by ``params_from_jax``
    and ``opt_state_from_jax``, saved by either package and loaded by the
    other, bit for bit, in JAX's leaf order and treedef."""
    cfg = jax_get_config(arch).reduced()
    jp = jT.init_params(cfg, jax.random.PRNGKey(6))
    grads = jax.tree.map(lambda a: jnp.asarray(
        np.random.default_rng(a.size).standard_normal(a.shape), a.dtype), jp)
    jp, js, _ = jax.jit(lambda p, g, s: jopt.adamw_update(
        jopt.AdamWConfig(), p, g, s))(jp, grads, jopt.init_opt_state(jp))
    tree = (params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
    assert ("shared_attn" in tree[0]) == (arch == "zamba2-7b")
    assert ("embed" in tree[0]) == (arch != "hubert-xlarge")
    assert jax_treedef(tree) == str(jax.tree.flatten((jp, js))[1])
    path = str(tmp_path / "port.msgpack")
    ck.save_checkpoint(path, tree, step=9)
    (rp, rs), step = jck.load_checkpoint(path, (jp, js))
    assert step == 9 and int(rs["step"]) == 1
    for want, got in zip(jax.tree.leaves((jp, js)),
                         jax.tree.leaves((rp, rs))):
        np.testing.assert_array_equal(bits(got), bits(want))
    path = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(path, (jp, js), step=10)
    like = (tree[0], opt.init_opt_state(tree[0]))
    (tp, ts), step = ck.load_checkpoint(path, like)
    assert step == 10 and ts["step"] == 1
    for want, got in zip(jax.tree.leaves((jp, js["m"], js["v"])),
                         jax_leaves((tp, ts["m"], ts["v"]))):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(bits(got), bits(want))


def test_load_checkpoint_checks_leaf_count_and_shapes(tmp_path):
    path = str(tmp_path / "c.msgpack")
    ck.save_checkpoint(path, {"a": torch.zeros(2, 3), "b": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        ck.load_checkpoint(path, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(path, {"a": torch.zeros(3, 2),
                                  "b": torch.ones(4)})
    assert not (tmp_path / "c.msgpack.tmp").exists()


def test_jax_leaf_order_sorts_dict_keys():
    tree = {"b": [torch.zeros(1), {"z": torch.ones(1), "a": torch.zeros(2)}],
            "a": torch.ones(3)}
    jtree = jax.tree.map(lambda t: np.asarray(t), tree)
    got = [tuple(t.shape) for t in jax_leaves(tree)]
    assert got == [a.shape for a in jax.tree.leaves(jtree)]
    back = jax_unflatten(tree, jax_leaves(tree))
    assert list(back) == ["b", "a"]
    assert all(x is y for x, y in zip(tree_leaves(back), tree_leaves(tree)))


def test_opt_state_from_jax_carries_moments_and_step(trained):
    jp, js = trained
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"] == 1 and isinstance(ts["step"], int)
    for a, b in zip(jax_leaves(ts["m"]), jax.tree.leaves(js["m"])):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tokenizer_matches_jax_in_one_process():
    texts = ["The quick brown fox", "jumps over the lazy dog " * 12, "",
             "UPPER lower MiXeD 123 !?"]
    for vocab in (3, 2000, 64000):
        mine, theirs = HashTokenizer(vocab), jtok.HashTokenizer(vocab)
        for n in (1, 8, 100):
            np.testing.assert_array_equal(mine.encode_batch(texts, n),
                                          theirs.encode_batch(texts, n))
            assert mine.encode(texts[0], n).dtype == np.int32
    with pytest.raises(ValueError):
        HashTokenizer(2)


def test_reduce_domain_matches_jax():
    toks = np.random.default_rng(8).integers(0, 5000, (6, 120))
    toks[:, 90:] = 0
    for vocab, n in ((2000, 100), (10, 5), (6000, 200)):
        got = reduce_domain(toks, vocab, n)
        np.testing.assert_array_equal(got, jtok.reduce_domain(toks, vocab, n))
        assert got.dtype == np.int32


def test_batch_iterator_matches_jax():
    rng = np.random.default_rng(2)
    data = {"x": rng.standard_normal((37, 5)).astype(np.float32),
            "y": rng.integers(0, 9, 37)}
    mine = iter(BatchIterator(data, 8, seed=4))
    theirs = iter(jpipe.BatchIterator(data, 8, seed=4))
    for _ in range(14):             # past three epochs of four batches
        a, b = next(mine), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        BatchIterator({"x": data["x"], "y": data["y"][:3]}, 8)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_make_batches_matches_jax(arch):
    mine = launch.make_batches(get_config(arch).reduced(), 4, 32, seed=3)
    theirs = jlaunch.make_batches(jax_get_config(arch).reduced(), 4, 32,
                                  seed=3)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], np.asarray(b["tokens"]))


def test_train_launcher_refuses_a_mesh():
    """``--mesh`` trains on a mesh now; one that does not fit the
    process count (one process here, no ``torchrun``) is refused with a
    ``ValueError``, as ``jax.make_mesh`` refuses a device count."""
    with pytest.raises(ValueError, match="mesh"):
        launch.parse_args(["--mesh", "2,1", "--device", "cpu"])
    assert dict(launch.parse_args(["--mesh", "1,1", "--device", "cpu"])
                .mesh.shape) == {"data": 1, "model": 1}


def test_train_launcher_setup_follows_jax_schedule():
    args = launch.parse_args(["--device", "cpu", "--smoke", "--steps", "30",
                              "--arch", "rwkv6-1.6b"])
    cfg, params, state, _ = launch.setup(args)
    assert cfg.name == "rwkv6-1.6b-smoke" and state["step"] == 0
    shapes = tree_map(lambda a: tuple(a.shape), params)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jT.init_params(
        jax_get_config("rwkv6-1.6b").reduced(), jax.random.PRNGKey(0)))
    assert shapes == jshapes
