"""The port's sharding plan against the JAX package's, and its dry-run.

The rules (``repro_torch.launch.sharding``) are pure functions of the
parameter paths and shapes, so every leaf of every arch is compared at
full width on duck-typed production meshes, with FSDP on and off, from
fake tensors (the port) and ``jax.eval_shape`` (JAX): nothing is
allocated. The dry-run CLI and the fake 2 x 2 mesh run in subprocesses:
a fake process group is process-global.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.tree_util import tree_flatten_with_path

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()


class FakeMesh:
    """Duck-typed mesh: .shape mapping + .axis_names (JAX's test's)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = 1
        for v in shape.values():
            self.size *= v


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _jax_names(path) -> tuple:
    return tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)


def _jax_specs(tree, fn) -> dict:
    flat, _ = tree_flatten_with_path(tree)
    return {_jax_names(p): tuple(fn(p, leaf)) for p, leaf in flat}


def _port_specs(tree, fn) -> dict:
    out = {}
    tree_map_with_path(lambda p, l: out.__setitem__(tuple(p), fn(p, l)),
                       tree)
    return out


@pytest.fixture(scope="module")
def jax_params():
    return {a: jax.eval_shape(lambda a=a: jT.init_params(
        jget(a), jax.random.PRNGKey(0))) for a in ARCHS}


@pytest.fixture(scope="module")
def port_params():
    return {a: specs.params_specs(get_config(a)) for a in ARCHS}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_jax_for_every_leaf(arch, fsdp, mesh, jax_params,
                                            port_params):
    m = FakeMesh(MESHES[mesh])
    want = _jax_specs(jax_params[arch],
                      lambda p, l: jsh.param_spec(p, l, m, fsdp=fsdp))
    got = _port_specs(port_params[arch],
                      lambda p, l: sh.param_spec(p, l, m, fsdp=fsdp))
    assert got == want


# JAX's single-leaf cases (tests/test_sharding_rules.py), one test
LEAF_CASES = [
    ("yi-6b", ("blocks", "attn", "wq", "w"), True, (None, "data", "model")),
    ("yi-6b", ("blocks", "attn", "wo", "w"), True, (None, "model", "data")),
    ("qwen3-moe-235b-a22b", ("blocks", "moe", "w_gate"), True,
     (None, "model", "data", None)),
    ("deepseek-67b", ("head", "w"), True, ("data", "model")),
    ("deepseek-67b", ("embed",), True, ("data", "model")),
    ("hubert-xlarge", ("head", "w"), True, (None, None)),
    ("qwen2-7b", ("final_norm",), True, (None,)),
    ("qwen2-7b", ("blocks", "norm1"), True, (None, None)),
    ("qwen2-7b", ("blocks", "attn", "wq", "b"), True, (None, "model")),
    ("deepseek-v2-lite-16b", ("blocks", "attn", "w_uk", "w"), True,
     (None, "data", "model")),
    ("yi-6b", ("blocks", "attn", "wq", "w"), False, (None, None, "model")),
]


@pytest.mark.parametrize("arch,path,fsdp,want", LEAF_CASES,
                         ids=[f"{a}:{'.'.join(p)}:{f}"
                              for a, p, f, _ in LEAF_CASES])
def test_single_leaf_rules(arch, path, fsdp, want, jax_params, port_params):
    m = FakeMesh(MESHES["single"])
    got = _port_specs(port_params[arch],
                      lambda p, l: sh.param_spec(p, l, m, fsdp=fsdp))[path]
    jwant = _jax_specs(jax_params[arch],
                       lambda p, l: jsh.param_spec(p, l, m, fsdp=fsdp))[path]
    assert got == want == jwant


def _cache_cases():
    for a in ARCHS:
        for name in ("decode_32k", "long_500k"):
            if shape_applicable(jget(a), JSHAPES[name])[0]:
                yield a, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", list(_cache_cases()))
def test_cache_specs_are_jax_for_every_leaf(arch, shape, mesh):
    m = FakeMesh(MESHES[mesh])
    s = INPUT_SHAPES[shape]
    jcache = jax.eval_shape(lambda: jT.make_cache(
        jget(arch), s.global_batch, s.seq_len))
    want = _jax_specs(jcache, lambda p, l: jsh.cache_spec(
        p, l, m, seq_len=s.seq_len))
    pcache = sh.eval_shape(lambda: T.make_cache(
        get_config(arch), s.global_batch, s.seq_len, device="cpu"))
    got = _port_specs(pcache, lambda p, l: sh.cache_spec(
        p, l, m, seq_len=s.seq_len))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_logits_specs_are_jax(arch, mesh):
    from jax.sharding import AbstractMesh
    m = FakeMesh(MESHES[mesh])
    am = AbstractMesh(tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
    for shape in ((256, 4096), (32, 32768, 1280), (1,), (128,), (3, 7)):
        assert sh.batch_spec(m, shape) == tuple(jsh.batch_spec(m, shape))
    for b in (1, 32, 128, 256):
        want = tuple(jsh.logits_sharding(jget(arch), am, b).spec)
        assert sh.logits_sharding(get_config(arch), m, b).spec == want


# the meshes whose idle batch axes GSPMD lays d_model over, and those it
# does not (JAX's HLO per chip: ``launch.sharding.width_axes``); d_model
# 2560 (h2o-danube-1.8b)
WIDTH_AXES = {(2, 2): ("data",), (4, 2): ("data",), (4, 4): ("data",),
              (8, 4): ("data",), (16, 16): ("data",),
              (2, 16, 16): ("pod", "data"), (2, 4): (), (3, 4): (),
              (4, 1): (), (8, 1): (), (1, 1): ()}


@pytest.mark.parametrize("sizes", list(WIDTH_AXES), ids=lambda s: "x".join(
    map(str, s)))
def test_stream_lays_d_model_over_idle_batch_axes(sizes):
    m = FakeMesh(dict(zip(("pod", "data", "model")[-len(sizes):], sizes)))
    ax = WIDTH_AXES[sizes]
    assert sh.width_axes(m, 2560) == ax
    for shape in ((1, 1, 2560), (1, 2560)):
        want = sh.batch_spec(m, shape)      # rows, or nothing, split
        if ax:
            want = want[:-1] + (ax if len(ax) > 1 else ax[0],)
        assert sh.stream_spec(m, shape) == want
    # a batch the axes divide keeps its rows split; 2560 / 3 does not
    # divide
    n = 1
    for a in ("pod", "data"):
        n *= m.shape.get(a, 1)
    assert sh.stream_spec(m, (n, 1, 2560)) == sh.batch_spec(m, (n, 1, 2560))
    assert sh.width_axes(m, 2561) == ()


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_jax_for_every_applicable_shape(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    n = 0
    for name, shape in INPUT_SHAPES.items():
        if not shape_applicable(jcfg, JSHAPES[name])[0]:
            continue
        want = jspecs.input_specs(jcfg, JSHAPES[name])
        got = specs.input_specs(cfg, shape)
        jflat, _ = tree_flatten_with_path(want)
        wmap = {_jax_names(p): (tuple(l.shape), str(l.dtype))
                for p, l in jflat}
        gmap = _port_specs(got, lambda p, l: (tuple(l.shape), _dtype(l)))
        assert gmap == wmap, name
        n += 1
    assert n >= 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_param_bytes_and_fsdp_policy_are_jax(arch, mesh):
    """Per-chip TP bytes equal JAX's; at 16 GB of HBM (three quarters:
    JAX's 12e9) the port's serving FSDP policy decides as JAX's; at the
    H100's 80 GB it decides by 60e9; training always FSDPs."""
    m = FakeMesh(MESHES[mesh])
    jcfg, cfg = jget(arch), get_config(arch)
    want = jspecs._tp_param_bytes_per_chip(jcfg, m)
    got = specs._tp_param_bytes_per_chip(cfg, m)
    assert got == pytest.approx(want, rel=1e-12)
    for name in ("prefill_32k", "decode_32k", "train_4k"):
        s = INPUT_SHAPES[name]
        jdecide = True if s.kind == "train" else want > 12e9
        assert specs.fsdp_policy(cfg, s, m, hbm_bytes=16e9) == jdecide
        assert specs.fsdp_policy(cfg, s, m) == (s.kind == "train"
                                                or got > 60e9)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_placements_round_trip(mesh, port_params):
    """Every spec the rules give (and a few hand-made ones, with the
    ("pod", "data") batch entry) turns into placements and back."""
    from torch.distributed.tensor import Replicate, Shard
    m = Mesh(MESHES[mesh])
    seen = set()
    for arch in ARCHS:
        for fsdp in (False, True):
            tree_map_with_path(lambda p, l: seen.add(
                sh.param_spec(p, l, m, fsdp=fsdp)), port_params[arch])
    seen |= {sh.batch_spec(m, (256, 4096)), (None, "model", None),
             ("data", None, "model", None), ()}
    assert len(seen) > 8
    for spec in seen:
        pl = sh.placements(spec, m)
        assert len(pl) == len(m.axis_names)
        assert sh.spec_of(pl, m, len(spec)) == spec, spec
    bspec = sh.batch_spec(m, (256, 8))
    if mesh == "multi":
        assert bspec == (("pod", "data"), None)
        assert sh.placements(bspec, m) == (Shard(0), Shard(0), Replicate())


def test_production_meshes_are_jax_shapes():
    for mp, shape in ((False, {"data": 16, "model": 16}),
                      (True, {"pod": 2, "data": 16, "model": 16})):
        m = make_production_mesh(multi_pod=mp)
        assert dict(m.shape) == shape and m.size == 16 * 16 * (2 if mp
                                                              else 1)
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    assert batch_axes(make_production_mesh(multi_pod=True)) == ("pod",
                                                                "data")
    assert dict(make_host_mesh().shape) == {"data": 1, "model": 1}


def test_plans_allocate_nothing(port_params):
    """The plan's shapes are fake tensors (no storage is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensor
    leaves = tree_leaves(port_params["qwen3-moe-235b-a22b"])
    assert leaves and all(isinstance(x, FakeTensor) for x in leaves)


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


def test_constrain_keeps_values_on_a_fake_2x2_mesh():
    """On a fake 2 x 2 mesh (rank 0 of 4; a subprocess, the group being
    process-global) the hints move shards and never change a value:
    ``constrain`` from a replicated tensor keeps rank 0's slice of it, a
    plain tensor passes through, and reduced yi-6b's prefill runs on
    DTensors to the same shapes as without a mesh."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.launch.mesh import Mesh, device_mesh, destroy
        from repro_torch.launch import sharding as sh
        from repro_torch.models.shard_hints import (constrain, use_mesh,
                                                    split_heads, gather)
        mesh = device_mesh(Mesh({"data": 2, "model": 2}), "fake")
        x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        d = sh.distribute(x, sh.NamedSharding(mesh, ()))
        with use_mesh(mesh):
            assert constrain(x, "data", None, "model") is x
            c = constrain(d, "data", None, "model")
            assert tuple(c.placements) == sh.placements(
                ("data", None, "model"), mesh)
            assert torch.equal(c.to_local(), x[:2, :, :4])
            same = constrain(c, "data", None, "model")
            assert same is c
            skip = constrain(c, None, "pod")
            assert skip is c
            h = split_heads(c, 4, 2)
            assert tuple(h.shape) == (4, 6, 4, 2)
            assert torch.equal(h.to_local(), x[:2, :, :4].reshape(2, 6, 2, 2))
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.specs import lower_step
        cfg = get_config("yi-6b").reduced()
        shape = ShapeConfig("p", 16, 4, "prefill")
        plain = lower_step(cfg, shape, Mesh({"data": 2, "model": 2})).run()
        sharded = lower_step(cfg, shape, mesh).run()
        assert tuple(sharded[0].shape) == tuple(plain[0].shape)
        destroy()
        print("OK")
    """)
    r = _run(["-c", code], timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout


def test_every_family_runs_on_a_fake_2x2_mesh():
    """Reduced configs of every family (GQA, MLA + MoE, RWKV6, zamba2,
    the encoder, the VLM) run their train, prefill and decode steps as
    DTensors on a fake 2 x 2 mesh (a subprocess), to the shapes the same
    steps give without a mesh: the hints cover each family's ops."""
    code = textwrap.dedent("""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.mesh import Mesh, device_mesh, destroy
        from repro_torch.launch.specs import lower_step
        from repro_torch.tree import tree_leaves
        mesh = device_mesh(Mesh({"data": 2, "model": 2}), "fake")
        plain = Mesh({"data": 2, "model": 2})
        n = 0
        for arch in ("qwen2-7b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
                     "zamba2-7b", "hubert-xlarge", "pixtral-12b"):
            cfg = get_config(arch).reduced()
            for kind in ("train", "prefill", "decode"):
                if kind == "decode" and not cfg.supports_decode:
                    continue
                shape = ShapeConfig(kind, 32, 4, kind)
                want = lower_step(cfg, shape, plain).run()
                got = lower_step(cfg, shape, mesh).run()
                shapes = [[tuple(x.shape) for x in tree_leaves(t)
                           if hasattr(x, "shape")] for t in (got, want)]
                assert shapes[0] == shapes[1], (arch, kind)
                n += 1
        destroy()
        print("OK", n)
    """)
    r = _run(["-c", code], timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK 17" in r.stdout, r.stdout[-500:]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "yi-6b"])
def test_dryrun_entrypoint_end_to_end(arch):
    """The 256-rank fake-mesh dry-run through its CLI, in a subprocess
    (the fake group is process-global): exit 0, ``OK``, and a record
    with per-chip bytes against the H100's 80 GB and the roofline's
    three terms."""
    import json
    out = ROOT / "build" / f"dryrun_test_{arch}.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              "decode_32k", "--json", str(out)], timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
    rec = json.loads(out.read_text().splitlines()[-1])
    out.unlink()
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["hbm_bytes"] == 80e9
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        assert 0 < mem[k] < mem["hbm_bytes"], (k, mem)
    rf = rec["roofline"]
    assert rf["method"] == "full-depth" and rf["chips"] == 256
    for k in ("compute_s", "memory_s", "collective_s"):
        assert rf[k] > 0, (k, rf)
