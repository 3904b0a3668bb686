"""The port's real meshes: the serving mesh, MoE dispatch groups and
``launch.train --mesh``.

* On a one-device mesh (a gloo group of one) the serving engine serves
  what JAX's ``data_parallel=True`` engine serves on one device; beside
  8 transport threads running rwkv6 or zamba2 prefills it serves as
  without the mesh (the mesh is the local step's thread's only).
* MoE with two dispatch groups (the ambient mesh's ``data`` size) agrees
  with JAX's ``moe_forward`` with its ``_dispatch_groups`` set to 2,
  under capacity, where the groups change which pairs drop.
* One ``torchrun`` of two gloo processes (this file's ``__main__``) runs
  the rest on a mesh of two CPU devices: ``constrain`` moving real
  shards without changing a value; the gated local step and a whole
  serve through ``ServeConfig(data_parallel=True)``, bitwise alike to
  no mesh (conf, pred and idx; every response and the bill); reduced
  yi-6b, deepseek-v2-lite, rwkv6 and zamba2, and reduced yi-6b with 1
  KV head and 4, 3 or 1 query heads (split 2/2, 2/1 and 1/0 over
  ``model``), trained on ``--mesh 2,1`` and ``--mesh 1,2`` against one
  process; with those heads a prefill (the query heads split over
  ``model``, each rank reading the one KV head) and decode over a cache
  whose slots the mesh shards, against one process; and the
  sharded MoE layer (rows over ``data``, or experts over ``model``)
  against JAX's: output, balance loss and gradients, and the balance
  loss's own gradient. One spawn, shared by two tests, keeps the suite
  inside its time limit.
* One ``torchrun`` of four: reduced yi-6b with 6 query heads on
  ``--mesh 1,4``, whose last rank holds none; and on 2 x 2, where a
  batch of one leaves ``data`` idle and the residual stream lays d_model
  over it (``launch.sharding.width_axes``), batch-1 greedy decodes and
  training steps against one process.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import BILLING_FIELDS  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_serving_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.shard_hints import use_mesh  # noqa: E402
from tests.test_torch_families import MOE_ARCHS, carry, moe_layer  # noqa: E402
from tests.test_torch_serving import (FIELDS, N_REQ, assert_gapped,  # noqa: E402, F401
                                      gap_cut, serve_both, world)

ROOT = Path(__file__).resolve().parents[1]
# one process's losses against the mesh's: fp32 sums of the same
# products split over two ranks (measured: 1e-6)
LOSS_RTOL = 1e-5
# the families whose mesh paths differ: dense GQA, MLA + MoE (expert
# parallelism, dispatch groups), the RWKV6 scan and zamba2's SSD
TRAIN_ARCHS = ("yi-6b", "deepseek-v2-lite-16b", "rwkv6-1.6b", "zamba2-7b")
# reduced yi-6b with (query, KV) heads whose one KV head does not divide
# the model axis of --mesh 1,2, so the query heads stay split there:
# 4 heads 2 and 2; 3 heads 2 and 1, as torch.chunk splits them; 1 head,
# which DTensor's broadcasting (rope's [.., T, 1, hd] angles) replicates
# back onto both ranks, a dim of 1 never staying split
GQA_ARCHS = {"yi-6b-kv1": (4, 1), "yi-6b-3q1kv": (3, 1),
             "yi-6b-1q1kv": (1, 1)}
# the prefill + decode's (query heads, KV heads, head_dim) on a (1, 2)
# mesh: those three; and 6 on 3 KV heads, which rank 0's query heads 0-2
# read 0, 0, 1, in no whole groups (each head gets its KV head's copy)
DECODE_HEADS = {"4/1": (4, 1, 64), "3/1": (3, 1, 64), "1/1": (1, 1, 64),
                "6/3": (6, 3, 32)}
# on four ranks (--mesh 1,4): 6 query heads on 2 KV heads split 2, 2, 2
# and 0, as qwen2-7b's 28 on 16 leave two ranks without. The empty rank's
# backward must reach the KV gradients' collectives as the others' do
# (layers.per_head_shard), else the group hangs
EMPTY_RANK_HEADS = (6, 2, 64)
EMPTY_RANK_ARCH = "yi-6b-6q2kv"
# batch-1 decode on the 2 x 2 mesh of those four ranks, where the batch
# leaves ``data`` idle: (arch, KV heads or None). h2o-danube's ring cache
# shards its 4 KV heads over ``model``; with 1 KV head it shards its slots
# and each rank weights the values of half the heads
# (``layers._idle_heads``); rwkv6's token shift and state, zamba2's
# mamba2 layers and shared block
BATCH_ONE = {"h2o-danube-1.8b": ("h2o-danube-1.8b", None),
             "h2o-danube-1.8b-kv1": ("h2o-danube-1.8b", 1),
             "rwkv6-1.6b": ("rwkv6-1.6b", None),
             "zamba2-7b": ("zamba2-7b", None)}
BATCH_ONE_STEPS = 6


@pytest.fixture
def group_of_one():
    """A gloo group of one in this process, torn down after."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_one_device_serving_mesh_serves_as_jax_data_parallel(world,
                                                             group_of_one):
    t_local = gap_cut(world["local_conf"])
    t_remote = gap_cut(world["remote_conf"])
    assert_gapped(world["local_conf"], t_local, "local conf vs t_local")
    assert_gapped(world["remote_conf"], t_remote, "remote conf vs t_remote")
    (jr, js), (tr, ts) = serve_both(
        world, {"data_parallel": True, "t_local": t_local,
                "t_remote": t_remote})
    assert len(tr) == N_REQ
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in FIELDS] == \
            [getattr(b, f) for f in FIELDS], a.uid
    for f in BILLING_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f
    assert ts.escalations > 0
    mesh = make_serving_mesh("cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_serving_mesh_stays_off_the_transport_threads(arch, group_of_one):
    """``data_parallel=True`` under continuous batching with 8 transport
    workers: the remote model's prefills run on the transport threads
    while the local step runs on the serving mesh. The mesh is the
    local step's thread's only, so the recurrent remote's prefill
    (``cache_like``) makes plain states there, and every response and
    the bill equal ``data_parallel=False``'s. The local step is slowed
    (the same answers) so that prefills do overlap it, and the test
    asserts they did."""
    import dataclasses
    import threading
    import time
    from repro_torch.launch import serve
    from repro_torch.serving.engine import BILLING_FIELDS as FIELDS_T

    args = serve.parse_args([
        "--device", "cpu", "--smoke", "--remote-arch", arch, "--requests",
        "64", "--batch", "16", "--set", "batching=continuous", "--set",
        "completion_mode=streaming", "--set", "pipeline_depth=2", "--set",
        "transport.max_concurrent=8", "--set", "transport.timeout_s=300"])
    stack = serve.build_stack(args)
    inside, overlaps = [0], [0]
    lock = threading.Lock()
    remote = stack.remote_apply

    def slow_local(x):
        with lock:
            inside[0] += 1
        try:
            time.sleep(0.02)
            return stack.local_apply(x)
        finally:
            with lock:
                inside[0] -= 1

    def watched_remote(batch):
        with lock:
            overlaps[0] += inside[0] > 0
        return remote(batch)

    stack.remote_apply = watched_remote
    served = []
    for dp in (False, True):
        stack.cfg = dataclasses.replace(stack.cfg, data_parallel=dp)
        res = serve.run(args, stack, local_apply=slow_local)
        assert (res.engine.mesh is not None) == dp
        assert res.engine.stats.remote_calls > 0
        served.append((sorted((tuple(getattr(r, f) for f in FIELDS)
                               for r in res.responses)),
                       [getattr(res.engine.stats, f) for f in FIELDS_T]))
    assert overlaps[0] > 0, "no remote prefill overlapped a local step"
    assert served[0] == served[1]


@pytest.mark.parametrize("mode", [1.25, 0.5])
def test_moe_two_dispatch_groups_match_jax(monkeypatch, mode):
    """Two groups of 48 tokens, each with its own capacity and queue
    positions: JAX with ``_dispatch_groups`` patched to 2 (restored by
    monkeypatch), the port under an ambient mesh whose ``data`` is 2."""
    jcfg, cfg, jp, x = moe_layer("qwen3-moe-235b-a22b")
    monkeypatch.setattr(jmoe, "_dispatch_groups", lambda n: 2)
    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x),
                                capacity_factor=mode)
    tp = carry(jp)
    with torch.no_grad(), use_mesh(Mesh({"data": 2, "model": 1})):
        assert moe._dispatch_groups(96) == 2
        ty, taux = moe.moe_forward(cfg, tp, torch.from_numpy(x),
                                   capacity_factor=mode)
    with torch.no_grad():
        one, _ = moe.moe_forward(cfg, tp, torch.from_numpy(x),
                                 capacity_factor=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert not np.allclose(ty.numpy(), one.numpy(), atol=1e-5), \
        "the groups should drop other pairs than one group"


def test_train_mesh_of_one_is_the_plain_step_bit_for_bit(group_of_one):
    """``train --mesh 1,1`` (a gloo group of one, every tensor a DTensor)
    gives the one-process losses exactly, as ``chip_smoke.py``'s
    ``train_mesh`` phase holds the card's run to them: work split over
    a mesh axis (the loss head's logsumexp over a vocabulary split over
    ``model``, ``shard_hints.logsumexp``) takes the plain path on an axis
    of one rank."""
    assert _losses("yi-6b", ["--mesh", "1,1"]) == _losses("yi-6b", [])


def test_train_mesh_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="mesh 2,2"):
        launch.parse_args(["--mesh", "2,2", "--device", "cpu"])
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(n: int, timeout: int) -> dict:
    """This file's ``__main__`` in ``n`` gloo processes: rank 0's JSON."""
    env = dict(os.environ, PYTHONPATH=f"src{os.pathsep}.",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-addr", "localhost", "--master-port",
         str(_free_port()), str(Path(__file__).resolve())],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def _check_train(res: dict) -> None:
    for arch, got in res["train"].items():
        # two dispatch groups drop other pairs than one, in JAX too: the
        # data-sharded MoE run is held to one process with two groups
        base = got.get("one_2_groups", got["one"])
        for mesh_arg in set(got) - {"one", "one_2_groups"}:
            np.testing.assert_allclose(
                got[mesh_arg], base if mesh_arg == "2,1" else got["one"],
                rtol=LOSS_RTOL, err_msg=f"{arch} {mesh_arg}")
        assert got["one"][-1] != got["one"][0], arch


def _check_decode(dec: dict) -> None:
    assert dec["layout"] == [None, "data", "model", None, None], dec
    # fp32 logits of a few units: the split softmax's rescale changes the
    # order of the sums only
    assert dec["max_abs_err"] <= 1e-5 * max(dec["scale"], 1.0), dec


@pytest.fixture(scope="module")
def two_ranks() -> dict:
    """This file's ``__main__`` on two gloo ranks, run once."""
    return _torchrun(2, 600)


def test_two_process_gloo_mesh(two_ranks):
    res = two_ranks
    assert res["constrain"] and res["gate"] and res["serve"], res
    assert all({"2,1", "1,2"} <= set(got) for got in res["train"].values())
    _check_train(res)
    assert set(res["decode"]) == set(DECODE_HEADS), res["decode"]
    for dec in res["decode"].values():
        _check_decode(dec)
    assert len(res["moe"]) == 2 * len(MOE_ARCHS) * 3
    for case, m in res["moe"].items():
        # the tolerances of test_moe_two_dispatch_groups_match_jax
        assert m["max_abs_err"] <= 1e-5, (case, m)
        assert m["aux"] == pytest.approx(m["jax_aux"], rel=1e-5), (case, m)
        # fp32 gradients summed over the ranks in another order
        assert m["grad_rel_err"] <= 1e-5, (case, m)


def test_sharded_moe_balance_loss_is_jax(two_ranks):
    """The sharded MoE's balance loss, its mean probabilities taken from
    the one router product that routes (ROADMAP C.10), and its own
    gradient (of the loss alone) into the router and x, against JAX's
    ``moe_forward`` on the same inputs and weights: rows over ``data``
    (two dispatch groups) and experts over ``model``, dropless and under
    capacity. Tolerances: the loss within 1e-5 relative (fp32 means over
    the ranks summed in another order); its gradient within 1e-5 of the
    largest gradient entry."""
    moe_res = two_ranks["moe"]
    assert len(moe_res) == 2 * len(MOE_ARCHS) * 3
    for case, m in moe_res.items():
        assert m["aux"] == pytest.approx(m["jax_aux"], rel=1e-5), (case, m)
        assert m["aux_grad_rel_err"] <= 1e-5, (case, m)


@pytest.fixture(scope="module")
def four_ranks() -> dict:
    """This file's ``__main__`` on four gloo ranks, run once."""
    return _torchrun(4, 300)


def test_four_process_gloo_mesh_leaves_a_rank_without_heads(four_ranks):
    """6 query heads on ``--mesh 1,4``: the rank without heads takes part
    in the backward's collectives (a hang otherwise), and the losses,
    prefill and decode agree with one process."""
    res = four_ranks
    assert set(res["train"][EMPTY_RANK_ARCH]) == {"one", "1,4"}, res
    _check_train({"train": {EMPTY_RANK_ARCH:
                            res["train"][EMPTY_RANK_ARCH]}})
    _check_decode(res["decode"])


def test_batch_one_on_an_idle_data_axis_is_one_process(four_ranks):
    """A batch of one on the 2 x 2 mesh leaves ``data`` idle, and the
    residual stream lays d_model over it, as GSPMD lays JAX's out: the
    greedy tokens of four archs (h2o-danube also with one KV head, its
    slots sharded) and three training steps of four are one process's,
    the logits and losses within fp32 reordering."""
    res = four_ranks
    _check_batch_one(res["batch_one"])
    one = {k: v for k, v in res["train"].items() if k.endswith("batch 1")}
    assert len(one) == len(TRAIN_ARCHS), res["train"]
    assert all(set(v) == {"one", "2,2"} for v in one.values()), one
    _check_train({"train": one})


def _check_batch_one(runs: dict) -> None:
    assert set(runs) == set(BATCH_ONE), runs
    for name, r in runs.items():
        assert r["stream"] == [None, None, "data"], (name, r)
        one, mesh = r["tokens"]
        assert mesh == one, (name, r)
        # fp32 logits: the partial sums over ``data`` and ``model`` add
        # the same products in another order (measured: 1.7e-6 of the
        # largest logit)
        assert r["max_abs_err"] <= 1e-5 * max(r["scale"], 1.0), (name, r)


# ------------------------------------------------------------ the worker

def _worker() -> None:
    """Rank r of a two-process gloo group (``torchrun``)."""
    from repro_torch.core.supervisors import max_softmax
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.sharding import (NamedSharding, distribute,
                                             shard_local_step)
    from repro_torch.models import surrogate as S
    from repro_torch.models import transformer as T
    from repro_torch.configs import get_config
    from repro_torch.models.shard_hints import constrain, gather
    from repro_torch.serving import Request, ServeConfig
    from repro_torch.serving.engine import make_gated_local_step

    dist.init_process_group("gloo")
    out = {}

    # constrain moves real shards and never a value
    mesh = device_mesh(Mesh({"data": 2, "model": 1}), "gloo")
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    d = distribute(x, NamedSharding(mesh, ()))
    with use_mesh(mesh):
        c = constrain(d, "data", None)
        ok = torch.equal(c.to_local(), x.chunk(2)[dist.get_rank()])
        ok &= torch.equal(gather(c), x)
    out["constrain"] = bool(ok)

    # the serving world: a surrogate and a reduced yi-6b, seeded alike on
    # both ranks
    scfg = S.SurrogateConfig(name="local", vocab_size=128, max_len=24,
                             d_model=32, num_heads=2, d_ff=32,
                             num_classes=8, dropout=0.0)
    sp = S.init_params(scfg, torch.Generator().manual_seed(0))
    sp["out"]["w"] = sp["out"]["w"] * 30.0
    rcfg = get_config("yi-6b").reduced()
    rp = T.init_params(rcfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 128, (64, 24)).astype(np.int32)

    @torch.no_grad()
    def local(tk):
        return S.apply(scfg, sp, tk)

    @torch.no_grad()
    def remote(batch):
        logits, _ = T.prefill(rcfg, rp, {"tokens": batch["tokens"]})
        return logits[:, :8]

    # the gated step alone, one window: bitwise alike
    step = make_gated_local_step(local)
    sharded = shard_local_step(step, mesh)
    conf = max_softmax(local(torch.from_numpy(toks))).numpy()
    t_local = float(np.median(conf))
    tl = torch.tensor(t_local)
    n = torch.tensor(16, dtype=torch.int32)
    same = True
    for w in range(4):
        xw = torch.from_numpy(toks[w * 16:(w + 1) * 16])
        a, b = step(xw, tl, n), sharded(xw, tl, n)
        same &= all(torch.equal(a[k], b[k]) for k in ("conf", "pred", "idx"))
    out["gate"] = bool(same)

    # a whole serve through ServeConfig: every response and the bill
    served = []
    for dp in (False, True):
        cfg = ServeConfig(batch_size=16, remote_fraction_budget=0.5,
                          t_local=t_local, t_remote=0.0, data_parallel=dp)
        eng, sched = cfg.build(local, remote, fallback=lambda r: -1,
                               device="cpu")
        try:
            for i in range(64):
                sched.submit(Request(uid=i, local_input=toks[i],
                                     remote_input={"tokens": toks[i]}))
            resp = sorted(sched.flush(), key=lambda r: r.uid)
        finally:
            eng.close()
        assert (eng.mesh is not None) == dp
        served.append(([tuple(getattr(r, f) for f in
                              ("uid", "prediction", "source",
                               "disposition", "backend", "cost"))
                        for r in resp],
                       [getattr(eng.stats, f) for f in BILLING_FIELDS]))
    out["serve"] = served[0] == served[1] and served[0][1][0] > 0

    # reduced models on one process, then on --mesh 2,1 and 1,2
    losses = _losses
    out["train"] = {}
    for arch in TRAIN_ARCHS:
        res = out["train"][arch] = {"one": losses(arch, [])}
        if get_config(arch).is_moe:
            res["one_2_groups"] = losses(arch, [], groups=2)
        for mesh_arg in ("2,1", "1,2"):
            res[mesh_arg] = losses(arch, ["--mesh", mesh_arg])
    # reduced yi-6b with one KV head: on --mesh 1,2 each rank keeps its
    # query heads and reads the one KV head, whose gradient is the two
    # ranks' partial sums (layers.per_head_shard)
    with _gqa_configs({a: (*h, 64) for a, h in GQA_ARCHS.items()}):
        for arch in GQA_ARCHS:
            out["train"][arch] = {
                "one": _losses(arch, [], smoke=False),
                **{m: _losses(arch, ["--mesh", m], smoke=False)
                   for m in ("2,1", "1,2")}}

    out["decode"] = {k: _slot_sharded_decode(rcfg, *h)
                     for k, h in DECODE_HEADS.items()}
    out["moe"] = _sharded_moe()
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _losses(arch, extra, groups=0, smoke=True, batch=4) -> list:
    """Three training steps' losses of ``arch`` (reduced with ``smoke``)
    through ``launch.train``: on one process, or with ``extra`` on a
    mesh."""
    args = launch.parse_args(["--device", "cpu", "--arch", arch,
                              "--steps", "3", "--batch", str(batch), "--seq",
                              "32", *(["--smoke"] if smoke else []),
                              *extra])
    cfg, params, opt, stepf = launch.setup(args)
    batches = launch.make_batches(cfg, args.batch, args.seq)
    ls = []
    for _ in range(args.steps):
        batch = launch.to_device(next(batches), args.device)
        # groups: one process under a mesh plan (no devices) whose data
        # axis makes that many MoE dispatch groups
        with (use_mesh(Mesh({"data": groups, "model": 1})) if groups
              else contextlib.nullcontext()):
            params, opt, m = stepf(params, opt, batch)
        ls.append(float(m["loss"]))
    return ls


@contextlib.contextmanager
def _gqa_configs(heads: dict):
    """``launch.get_config`` also knowing each name of ``heads`` as
    reduced yi-6b with its (query heads, KV heads, head_dim)."""
    import dataclasses
    orig = launch.get_config
    launch.get_config = lambda a: dataclasses.replace(
        orig("yi-6b").reduced(), name=a, num_heads=heads[a][0],
        num_kv_heads=heads[a][1], head_dim=heads[a][2]) \
        if a in heads else orig(a)
    try:
        yield
    finally:
        launch.get_config = orig


def _empty_rank_worker() -> None:
    """Rank r of a four-process gloo group (``torchrun``): reduced yi-6b
    with 6 query heads on 2 KV heads, which ``--mesh 1,4`` splits 2, 2,
    2 and 0; three training steps against one process, and a prefill +
    decode over a slot-sharded cache against one process. Then, on the
    2 x 2 mesh, batch-1 greedy decodes (``BATCH_ONE``) and three batch-1
    training steps of reduced deepseek-v2-lite, rwkv6, zamba2 and
    h2o-danube, each against one process."""
    from repro_torch.configs import get_config

    dist.init_process_group("gloo")
    with _gqa_configs({EMPTY_RANK_ARCH: EMPTY_RANK_HEADS}):
        out = {"train": {EMPTY_RANK_ARCH: {
            "one": _losses(EMPTY_RANK_ARCH, [], smoke=False),
            "1,4": _losses(EMPTY_RANK_ARCH, ["--mesh", "1,4"],
                           smoke=False)}}}
    out["decode"] = _slot_sharded_decode(get_config("yi-6b").reduced(),
                                         *EMPTY_RANK_HEADS, model=4)
    out["batch_one"] = {name: _batch_one_decode(arch, kv)
                        for name, (arch, kv) in BATCH_ONE.items()}
    # training at batch 1 on 2 x 2: the split products' gradients
    # (``shard_hints._row_product``'s through ``map_local``)
    for arch in TRAIN_ARCHS[1:] + ("h2o-danube-1.8b",):
        out["train"][f"{arch} batch 1"] = {
            "one": _losses(arch, [], batch=1),
            "2,2": _losses(arch, ["--mesh", "2,2"], batch=1)}
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _slot_sharded_decode(rcfg, heads: int, kv: int, hd: int,
                         model: int = 2) -> dict:
    """Prefill, then 4 decode steps, of reduced yi-6b with ``heads``
    query and ``kv`` KV heads on a (1, ``model``) mesh whose model axis
    the KV heads do not divide: the prefill splits the query heads, each rank
    reading the KV heads they use (``layers.per_head_shard``), the
    cache shards its slots and each decode step combines two ranks'
    partial softmaxes (``layers._decode_attn_sharded``). Against the
    same on one process: the largest logit difference."""
    import dataclasses
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.shard_hints import gather
    from repro_torch.serving.generate import graft
    from repro_torch.tree import tree_map

    mesh = device_mesh(Mesh({"data": 1, "model": model}), "gloo")
    cfg = dataclasses.replace(rcfg, num_heads=heads, num_kv_heads=kv,
                              head_dim=hd)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32))
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (4, 2)).astype(np.int32))

    def run(p, on_mesh):
        def put(t):
            return sh.distribute(t, sh.NamedSharding(
                mesh, sh.batch_spec(mesh, tuple(t.shape)))) if on_mesh \
                else t
        with torch.no_grad(), (use_mesh(mesh) if on_mesh
                               else contextlib.nullcontext()):
            logits, pc = T.prefill(cfg, p, {"tokens": put(prompt)})
            cache = graft(T.make_cache(cfg, 2, 16, device="cpu"),
                          tree_map(gather, pc))
            if on_mesh:
                cache = sh.distribute_tree(cache, sh.cache_shardings(
                    cfg, mesh, 2, 16))
            layout = sh.spec_of(cache["main"]["k"].placements, mesh, 5) \
                if on_mesh else None
            outs = [gather(logits)]
            for i in range(len(toks)):
                logits, cache = T.decode_step(cfg, p, put(toks[i]), cache,
                                              prompt.shape[1] + i)
                outs.append(gather(logits))
        return torch.stack(outs), layout

    want, _ = run(params, False)
    got, layout = run(sh.distribute_tree(params, sh.params_shardings(
        cfg, mesh)), True)
    return {"max_abs_err": float((got - want).abs().max()),
            "scale": float(want.abs().max()), "layout": layout}


def _batch_one_decode(arch: str, kv: int | None) -> dict:
    """Greedy generation of one row (a 12-token prompt, then
    ``BATCH_ONE_STEPS`` tokens, each the argmax of the last logits) of
    reduced ``arch`` (its KV heads replaced by ``kv``) on the 2 x 2 mesh,
    where the batch leaves ``data`` idle and the residual stream lays
    d_model over it (``shard_hints.rows``, ``project``), against one
    process: both runs' tokens, the largest logit difference, and the
    stream's spec."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.shard_hints import gather
    from repro_torch.serving.generate import graft
    from repro_torch.tree import tree_map

    mesh = device_mesh(Mesh({"data": 2, "model": 2}), "gloo")
    cfg = get_config(arch).reduced()
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    params = T.init_params(cfg, torch.Generator().manual_seed(9))
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (1, 12)).astype(np.int32))
    n = prompt.shape[1] + BATCH_ONE_STEPS

    def run(p, on_mesh):
        def put(t):
            return sh.distribute(t, sh.NamedSharding(
                mesh, sh.batch_spec(mesh, tuple(t.shape)))) if on_mesh \
                else t
        with torch.no_grad(), (use_mesh(mesh) if on_mesh
                               else contextlib.nullcontext()):
            logits, pc = T.prefill(cfg, p, {"tokens": put(prompt)})
            cache = graft(T.make_cache(cfg, 1, n, device="cpu"),
                          tree_map(gather, pc))
            if on_mesh:
                cache = sh.distribute_tree(cache, sh.cache_shardings(
                    cfg, mesh, 1, n))
            outs, toks = [gather(logits)], []
            for i in range(BATCH_ONE_STEPS):
                toks.append(int(outs[-1][0].argmax()))
                logits, cache = T.decode_step(
                    cfg, p, put(torch.tensor([toks[-1]], dtype=torch.int32)),
                    cache, prompt.shape[1] + i)
                outs.append(gather(logits))
        return torch.stack(outs), toks

    want, want_toks = run(params, False)
    got, got_toks = run(sh.distribute_tree(params, sh.params_shardings(
        cfg, mesh)), True)
    return {"tokens": [want_toks, got_toks],
            "max_abs_err": float((got - want).abs().max()),
            "scale": float(want.abs().max()),
            "stream": list(sh.stream_spec(mesh, (1, 1, cfg.d_model)))}


def _sharded_moe() -> dict:
    """One reduced MoE layer (``test_torch_families.moe_layer``'s) as
    DTensors on a (2, 1) mesh, each data rank's rows its dispatch group,
    against JAX's ``moe_forward`` with ``_dispatch_groups`` patched to 2;
    and on a (1, 2) mesh, the experts sharded over ``model`` (expert
    parallelism, one group), against JAX's unpatched: for each, the
    largest output difference, both balance losses and the largest
    gradient difference (of ``sum(y * c) + aux``, c fixed) relative to
    the largest gradient, of x, the router and each expert stack, and
    the same of the balance loss's own gradient, of the router and x."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.shard_hints import gather

    res = {}
    layouts = {"data": (Mesh({"data": 2, "model": 1}), 2),
               "model": (Mesh({"data": 1, "model": 2}), 1)}
    for name, (plan, groups) in layouts.items():
        mesh = device_mesh(plan, "gloo")
        for arch in MOE_ARCHS:
            jcfg, cfg, jp, x = moe_layer(arch)
            c = np.random.default_rng(11).standard_normal(
                x.shape).astype(np.float32)
            tp = carry(jp)
            tp = {k: sh.distribute(v, sh.NamedSharding(
                      mesh, ("model", None, None)))
                  if k in ("w_gate", "w_up", "w_down") else v
                  for k, v in tp.items()}
            tx = sh.distribute(torch.from_numpy(x), sh.NamedSharding(
                mesh, sh.batch_spec(mesh, x.shape)))
            for mode in ("dropless", 1.25, 0.5):
                kw = ({"dropless": True} if mode == "dropless"
                      else {"capacity_factor": mode})
                orig = jmoe._dispatch_groups
                jmoe._dispatch_groups = lambda n, g=groups: g
                try:
                    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x),
                                                **kw)
                    jg = jax.grad(lambda p, x: jnp.sum(jmoe.moe_forward(
                        jcfg, p, x, **kw)[0] * c) + jmoe.moe_forward(
                        jcfg, p, x, **kw)[1], argnums=(0, 1))(
                        jp, jnp.asarray(x))
                finally:
                    jmoe._dispatch_groups = orig
                leaves = [tp["router"]["w"], tp["w_gate"], tp["w_up"],
                          tp["w_down"], tx]
                for t in leaves:
                    t.grad = None
                    t.requires_grad_(True)
                with use_mesh(mesh):
                    ty, taux = moe.moe_forward(cfg, tp, tx, **kw)
                    (torch.sum(ty * torch.from_numpy(c)) + taux).backward()
                want = [jg[0]["router"]["w"], jg[0]["w_gate"],
                        jg[0]["w_up"], jg[0]["w_down"], jg[1]]
                grads = [gather(t.grad).numpy() for t in leaves]
                # the balance loss alone: its gradient into the router
                # and x, through the routes' one router product
                jmoe._dispatch_groups = lambda n, g=groups: g
                try:
                    ja = jax.grad(lambda p, x: jmoe.moe_forward(
                        jcfg, p, x, **kw)[1], argnums=(0, 1))(
                        jp, jnp.asarray(x))
                finally:
                    jmoe._dispatch_groups = orig
                aux_leaves = [tp["router"]["w"], tx]
                for t in aux_leaves:
                    t.grad = None
                with use_mesh(mesh):
                    moe.moe_forward(cfg, tp, tx, **kw)[1].backward()
                res[f"{name} {arch} {mode}"] = {
                    "max_abs_err": float(np.abs(
                        gather(ty).detach().numpy() - np.asarray(jy)).max()),
                    "aux": float(gather(taux)), "jax_aux": float(jaux),
                    "grad_rel_err": max(
                        float(np.abs(g - np.asarray(w)).max()
                              / np.abs(np.asarray(w)).max())
                        for g, w in zip(grads, want)),
                    "aux_grad_rel_err": max(
                        float(np.abs(gather(t.grad).numpy() - np.asarray(w))
                              .max() / np.abs(np.asarray(w)).max())
                        for t, w in zip(aux_leaves,
                                        (ja[0]["router"]["w"], ja[1])))}
    return res


if __name__ == "__main__":
    _empty_rank_worker() if os.environ["WORLD_SIZE"] == "4" else _worker()
