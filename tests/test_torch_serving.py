"""The serving slice of the PyTorch port against the JAX package, end to
end: the same ``ServeConfig``, carried weights (a surrogate and a reduced
yi-6b remote tier) and the same requests go through ``ServeConfig.build``
in both packages; every response and the billing must be equal.

The port runs on the CPU (``device="cpu"``), where its kernels' plain
versions run. Floats differ between the packages by ~1e-6 (f32 sums in
another order), so before comparing, each test asserts that no local
confidence lies within 1e-4 of ``t_local`` or of the capacity cut, and no
remote confidence within 1e-4 of ``t_remote``: a failure then names the
inputs rather than the port. Integer and string fields (prediction,
source, disposition, backend) and the billing fields must be equal; costs
are sums of the same constants in the same order and must be equal too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import make_classification_task  # noqa: E402
from repro.models import surrogate as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.runtime import content_key as jax_content_key  # noqa: E402
from repro.runtime import content_keys as jax_content_keys  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving.engine import BILLING_FIELDS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.supervisors import max_softmax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import surrogate as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import content_key, content_keys, to_host  # noqa: E402
from repro_torch.serving import CascadeEngine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

N_REQ, BATCH, NCLS, GAP = 64, 16, 8, 1e-4
SCFG = dict(name="local", vocab_size=128, max_len=24, d_model=32,
            num_heads=2, d_ff=32, num_classes=NCLS, dropout=0.0)


@pytest.fixture(scope="module")
def world():
    """Weights, requests and both packages' tier callables."""
    jscfg = jS.SurrogateConfig(**SCFG)
    sp = jax.tree.map(np.asarray, jS.init_params(jscfg,
                                                 jax.random.PRNGKey(0)))
    sp["out"]["w"] = sp["out"]["w"] * 30.0       # spread the confidences
    rcfg = jax_get_config("yi-6b").reduced()
    rp = jax.tree.map(np.asarray, jT.init_params(rcfg, jax.random.PRNGKey(7)))
    toks, labels, _ = make_classification_task(
        1, n=N_REQ, vocab=512, seq_len=48, num_classes=NCLS)
    toks = toks % rcfg.vocab_size
    local_toks = (toks[:, :24] % 128).astype(np.int32)
    oracle = (np.eye(NCLS, dtype=np.float32)[labels] * 2.0)

    jsp, jrp = jax.tree.map(jnp.asarray, sp), jax.tree.map(jnp.asarray, rp)

    def jlocal(tk):
        return jS.apply(jscfg, jsp, tk)

    def jremote(batch):
        logits, _ = jT.prefill(rcfg, jrp, {"tokens": jnp.asarray(
            batch["tokens"])})
        idx = jnp.asarray(batch["idx"])
        return jnp.asarray(oracle)[idx] + logits[:, :NCLS]

    tscfg = S.SurrogateConfig(**SCFG)
    trcfg = get_config("yi-6b").reduced()
    tsp, trp = params_from_jax(sp, "cpu"), params_from_jax(rp, "cpu")
    toracle = torch.from_numpy(oracle)

    @torch.no_grad()
    def tlocal(tk):
        return S.apply(tscfg, tsp, tk)

    @torch.no_grad()
    def tremote(batch):
        logits, _ = T.prefill(trcfg, trp, {"tokens": batch["tokens"]})
        idx = torch.as_tensor(np.asarray(batch["idx"])).long()
        return toracle[idx] + logits[:, :NCLS]

    # the gaps are checked on the port's confidences (the packages agree
    # to ~1e-6, far inside GAP)
    local_conf = max_softmax(tlocal(torch.from_numpy(local_toks))).numpy()
    remote_conf = max_softmax(tremote(
        {"tokens": toks, "idx": np.arange(N_REQ)})).numpy()
    return dict(toks=toks, local_toks=local_toks, jlocal=jlocal,
                jremote=jremote, tlocal=tlocal, tremote=tremote,
                local_conf=local_conf, remote_conf=remote_conf,
                tsp=tsp, tscfg=tscfg)


def gap_cut(conf: np.ndarray) -> float:
    c = np.sort(conf.astype(np.float64))
    lo, hi = len(c) // 4, 3 * len(c) // 4
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    return float((c[i] + c[i + 1]) / 2)


def assert_gapped(conf: np.ndarray, cut: float, what: str) -> None:
    assert np.abs(conf - cut).min() > GAP, f"inputs: {what} too close"


REMOTE_TIMEOUT = ["transport.timeout_s=300"]


def serve_both(world, overrides: dict, local=None):
    """Serve the same requests through both packages' ServeConfig.build.

    The transport's window deadline is raised far above any compile time:
    the JAX remote tier compiles at each new window shape, and on a loaded
    host that outlasts the default 2 s, which would turn a window into a
    fallback in one package only. Each run then asserts that no window was
    lost to the transport, so a timeout names itself instead of showing up
    as a routing mismatch."""
    base = dict(batch_size=BATCH, remote_fraction_budget=1.0)
    base.update(overrides)
    jcfg, tcfg = JaxServeConfig(**base), ServeConfig(**base)
    if not base.get("fused"):
        jcfg = jcfg.with_overrides(REMOTE_TIMEOUT)
        tcfg = tcfg.with_overrides(REMOTE_TIMEOUT)
    out = []
    for pkg, cfg in (("jax", jcfg), ("torch", tcfg)):
        if pkg == "jax":
            key, keys, req = jax_content_key, jax_content_keys, JaxRequest
            loc, rem, kw = world["jlocal"], world["jremote"], {}
        else:
            key, keys, req = content_key, content_keys, Request
            loc, rem, kw = local or world["tlocal"], world["tremote"], \
                {"device": "cpu"}
        if cfg.fused:
            eng, sched = cfg.build(loc, rem, fallback=lambda r: -1, **kw)
        else:
            eng, sched = cfg.build(
                loc, transport=cfg.build_router(rem),
                cache=cfg.build_cache(
                    key_fn=lambda row, key=key: key(row["tokens"]),
                    key_batch_fn=lambda b, n, keys=keys: keys(b["tokens"], n)),
                fallback=lambda r: -1, **kw)
        try:
            for i in range(N_REQ):
                sched.submit(req(uid=i, local_input=world["local_toks"][i],
                                 remote_input={"tokens": world["toks"][i],
                                               "idx": np.int32(i)}))
            responses = sched.flush()
        finally:
            eng.close()
        assert eng.stats.transport_failures == 0, (pkg, eng.stats)
        for backend in eng.router or ():
            assert backend.stats.timeouts == 0, (pkg, backend.name,
                                                 backend.stats)
        out.append((sorted(responses, key=lambda r: r.uid), eng.stats))
    return out


FIELDS = ("uid", "prediction", "source", "disposition", "backend", "cost")

VARIANTS = {
    "window": {},
    "streaming": {"pipeline_depth": 2, "completion_mode": "streaming"},
    "continuous": {"pipeline_depth": 2, "completion_mode": "streaming",
                   "batching": "continuous"},
}


@pytest.mark.parametrize("variant", ["window", "streaming", "continuous"])
def test_slice_matches_jax_engine(world, variant):
    t_local = gap_cut(world["local_conf"])
    t_remote = gap_cut(world["remote_conf"])
    assert_gapped(world["local_conf"], t_local, "local conf vs t_local")
    assert_gapped(world["remote_conf"], t_remote, "remote conf vs t_remote")
    (jr, js), (tr, ts) = serve_both(
        world, {**VARIANTS[variant], "t_local": t_local,
                "t_remote": t_remote})
    assert len(tr) == N_REQ
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in FIELDS] == \
            [getattr(b, f) for f in FIELDS], a.uid
    for f in BILLING_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f
    assert set(js.per_backend) == set(ts.per_backend)
    assert ts.escalations > 0 and ts.escalations < N_REQ


def test_fused_path_matches_jax_engine(world):
    """The fused step (capacity-k, no transport) in both packages."""
    k = 4
    conf = world["local_conf"]
    for w in range(N_REQ // BATCH):
        c = np.sort(conf[w * BATCH:(w + 1) * BATCH])
        assert c[k] - c[k - 1] > GAP, "inputs: capacity cut too close"
    t_remote = gap_cut(world["remote_conf"])
    assert_gapped(world["remote_conf"], t_remote, "remote conf vs t_remote")
    (jr, js), (tr, ts) = serve_both(
        world, {"fused": True, "remote_fraction_budget": k / BATCH,
                "t_remote": t_remote})
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in FIELDS[:4]] == \
            [getattr(b, f) for f in FIELDS[:4]], a.uid
    for f in BILLING_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f


def test_fused_local_head_serves_like_plain_local(world):
    """A FusedLocalHead over the same surrogate is a drop-in local tier:
    the port's engine routes exactly as with the composed logits."""
    from repro_torch.kernels.fused_head_gate.ops import FusedLocalHead
    scfg, sp = world["tscfg"], world["tsp"]

    @torch.no_grad()
    def trunk(tk):
        return S.apply(scfg, sp, tk, return_hidden=True)[1]

    head = FusedLocalHead(trunk, sp["out"]["w"], sp["out"]["b"])
    t_local = gap_cut(world["local_conf"])
    over = {"t_local": t_local, "t_remote": gap_cut(world["remote_conf"])}
    (jr, js), (tr, ts) = serve_both(world, over, local=head)
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in FIELDS] == \
            [getattr(b, f) for f in FIELDS], a.uid


def test_content_keys_hash_alike():
    rows = np.random.default_rng(0).integers(0, 500, (5, 48)).astype(np.int32)
    assert content_key(rows[2]) == jax_content_key(rows[2])
    assert content_keys(rows, 5) == jax_content_keys(rows, 5)
    assert content_keys(torch.from_numpy(rows), 5) == \
        jax_content_keys(rows, 5)
    np.testing.assert_array_equal(to_host(torch.from_numpy(rows)), rows)


# ------------------------------------------------------------- unported

@pytest.mark.parametrize("override,match", [
    ({"tiers": (object(),)}, "tiers"),
    ({"replicas": 2, "adaptive": True}, "replicas"),
    ({"data_parallel": True}, "data_parallel"),
])
def test_unported_serve_config_options_raise(override, match):
    with pytest.raises(NotImplementedError, match=match):
        ServeConfig(**override)


@pytest.mark.parametrize("kw,match", [({"early_emit": True}, "early_emit"),
                                      ({"mesh": object()}, "mesh")])
def test_unported_engine_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        CascadeEngine(lambda x: x, batch_size=4, remote_fraction_budget=0.5,
                      t_remote=0.5, transport=object(), device="cpu", **kw)


def test_engine_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeEngine(lambda x: x, lambda x: x, batch_size=4,
                      remote_fraction_budget=0.5, t_remote=0.5)


# ------------------------------------------------------ the entry point

def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--requests", "32",
                       "--batch", "16"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 32 requests" in out and "remote tier yi-6b-smoke" in out


def test_serve_main_requires_cuda_unless_cpu_is_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        serve.main(["--smoke", "--requests", "8"])
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err


def test_serve_flags_match_jax_serve():
    """The port keeps every flag of ``repro.launch.serve`` and adds
    ``--device``."""
    import inspect
    import re

    from repro.launch import serve as jserve
    jflags = set(re.findall(r'add_argument\("(--[\w-]+)"',
                            inspect.getsource(jserve.main)))
    ours = {o for a in serve._parser()._actions for o in a.option_strings
            if o.startswith("--")}
    assert ours - {"--help"} == jflags | {"--device"}
