"""The N-tier stage ladder in the PyTorch port against the JAX package: the
counterparts of ``tests/test_hierarchy.py``, and the hard checks of
``benchmarks/hierarchy_bench.py`` at a small ``--rows``.

Each test runs the same scenario in both packages (the port on the CPU)
and asserts what the JAX test asserts on the port's result, and that both
agree: ``TieredCascade.serve`` gives the same prediction, answering stage,
acceptance and cost per row; stage statistics, billing fields and
per-backend attribution are equal. Tolerances: a supervisor confidence
within 1e-6 of JAX's (float32 softmax summed in another order), and so a
swept threshold (a quantile of those confidences) within 1e-6; every
integer, string and count exact, and costs (sums of the same constants in
the same order) exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime as jrt  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro.serving.engine as jengine  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
import repro_torch.serving.engine as tengine  # noqa: E402
from repro.core.supervisors import SOFTMAX_SUPERVISORS as JSUP  # noqa: E402
from repro_torch.core.supervisors import SOFTMAX_SUPERVISORS as TSUP  # noqa: E402
from tests.test_torch_chaos import port_swap  # noqa: E402

NCLS = 6
CONF_TOL = 1e-6


def jax_score(logits):
    return np.asarray(JSUP["max_softmax"](jnp.asarray(logits)), np.float64)


def torch_score(logits):
    return TSUP["max_softmax"](torch.as_tensor(np.asarray(logits))
                               ).numpy().astype(np.float64)


JAX = SimpleNamespace(name="jax", rt=jrt, serving=jserving, engine=jengine,
                      score=jax_score, kw={},
                      local=lambda x: x + 0.3 * jnp.sin(17.0 * x),
                      take=lambda tbl: (lambda i: jnp.take(
                          jnp.asarray(tbl), i, axis=0)))
TORCH = SimpleNamespace(name="torch", rt=trt, serving=tserving,
                        engine=tengine, score=torch_score,
                        kw={"device": "cpu"},
                        local=lambda x: x + 0.3 * torch.sin(17.0 * x),
                        take=lambda tbl: (lambda i: torch.as_tensor(tbl)[
                            torch.as_tensor(i).long()]))
BOTH = (JAX, TORCH)


def quiet_tconf(p):
    return p.rt.TransportConfig(retry_backoff_s=0.0, max_retries=0,
                                breaker_failures=10 ** 6, timeout_s=60.0)


def planted_tiers(rows: int, seed: int, n_tiers: int = 3):
    """Cumulative-skill logit LUTs: tier i solves difficulty bands
    <= i confidently, is unsure elsewhere (same planting as the bench)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NCLS, rows)
    band = rng.choice(n_tiers, rows)
    tables = []
    for solves in range(n_tiers):
        solved = band <= solves
        wrong = (labels + rng.integers(1, NCLS, rows)) % NCLS
        target = np.where(solved, labels, wrong)
        margin = np.where(solved, rng.uniform(4.0, 6.0, rows),
                          rng.uniform(0.2, 0.8, rows))
        logits = rng.normal(0, 0.05, (rows, NCLS))
        logits[np.arange(rows), target] += margin
        tables.append(np.float32(logits))
    return labels, tables


def conf_correct(p, logits, labels):
    return p.score(logits), logits.argmax(-1) == labels


def lut_apply(table: np.ndarray):
    return lambda batch: table[np.asarray(batch["idx"])]


def build_ladder(p, tables, thresholds, costs):
    return p.rt.build_stage_chain([
        dict(name=f"t{i}", apply=lut_apply(tbl), config=quiet_tconf(p),
             cost_per_request=c, threshold=float(t))
        for i, (tbl, t, c) in enumerate(zip(tables, thresholds, costs))])


def same_points(jp, tp) -> None:
    """Joint operating points equal: thresholds within CONF_TOL, every
    fraction, rate, accuracy and cost exact."""
    assert len(jp) == len(tp) > 0
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.thresholds, a.thresholds, rtol=0,
                                   atol=CONF_TOL)
        for f in ("stage_fractions", "rejection_rate", "accuracy",
                  "system_accuracy", "cost_per_request"):
            assert getattr(a, f) == getattr(b, f), f


def swept(p, seed, costs, grid=7):
    labels, tables = planted_tiers(400, seed=seed)
    confs, oks = zip(*(conf_correct(p, t, labels) for t in tables))
    return p.rt.sweep_joint_operating_points(list(confs), list(oks),
                                             grid=grid, stage_costs=costs)


def test_scores_agree_with_jax():
    _, tables = planted_tiers(400, seed=0)
    for t in tables:
        np.testing.assert_allclose(torch_score(t), jax_score(t), rtol=0,
                                   atol=CONF_TOL)


# --------------------------------------------------- joint calibration

def test_joint_sweep_two_tier_reproduces_legacy_exactly():
    out = {}
    for p in BOTH:
        labels, (dev, _, cloud) = planted_tiers(400, seed=0)
        lc, lok = conf_correct(p, dev, labels)
        rc, rok = conf_correct(p, cloud, labels)
        legacy = p.rt.sweep_operating_points(
            lc, lok, rc, rok, grid=9, remote_cost_per_request=0.0048)
        joint = p.rt.sweep_joint_operating_points(
            [lc, rc], [lok, rok], grid=9, stage_costs=[0.0, 0.0048])
        assert len(legacy) == len(joint) > 0
        for lp, jp in zip(legacy, joint):
            assert jp.thresholds == (lp.t_local, lp.t_remote)
            assert jp.stage_fractions[0] == 1.0
            assert jp.stage_fractions[1] == lp.remote_fraction
            assert jp.rejection_rate == lp.rejection_rate
            assert jp.accuracy == lp.accuracy
            assert jp.system_accuracy == lp.system_accuracy
            assert jp.cost_per_request == lp.cost_per_request
        out[p.name] = joint
    same_points(out["jax"], out["torch"])


def test_joint_frontier_non_dominated_and_monotone():
    costs = [0.0, 0.001, 0.005]
    pts = swept(TORCH, 1, costs)
    same_points(swept(JAX, 1, costs), pts)
    front = trt.joint_pareto_frontier(pts)
    same_points(jrt.joint_pareto_frontier(swept(JAX, 1, costs)), front)
    for fp in front:
        for p in pts:
            dominates = (p.cost_per_request <= fp.cost_per_request
                         and p.system_accuracy >= fp.system_accuracy
                         and (p.cost_per_request < fp.cost_per_request
                              or p.system_accuracy > fp.system_accuracy))
            assert not dominates
    for a, b in zip(front, front[1:]):
        assert b.cost_per_request > a.cost_per_request
        assert b.system_accuracy > a.system_accuracy


def test_select_joint_respects_cost_budget():
    costs = [0.0, 0.001, 0.005]
    picks = {}
    for p in BOTH:
        pts = swept(p, 2, costs)
        budget = 0.002
        pick = p.rt.select_joint_operating_point(pts, cost_budget=budget)
        assert pick.cost_per_request <= budget + 1e-12
        feasible = [q for q in pts if q.cost_per_request <= budget + 1e-12]
        assert pick.system_accuracy == max(q.system_accuracy
                                           for q in feasible)
        floor = p.rt.select_joint_operating_point(pts, cost_budget=-1.0)
        assert floor.cost_per_request == min(q.cost_per_request
                                             for q in pts)
        picks[p.name] = [pick, floor]
    same_points(picks["jax"], picks["torch"])


# ------------------------------------------------------ tiered cascade

def serve_ladder(p, tables, thresholds, costs, batch):
    cascade = p.rt.TieredCascade(build_ladder(p, tables, thresholds, costs))
    out = cascade.serve(batch)
    stats = {n: vars(s).copy() for n, s in cascade.stats().items()}
    cascade.shutdown()
    return out, stats


def same_result(a, b) -> None:
    """Two ``TieredResult``s: prediction, stage, accepted, cost and stage
    index exact; confidences within CONF_TOL."""
    for f in ("prediction", "stage", "accepted", "cost", "stage_index"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    np.testing.assert_allclose(b.conf, a.conf, rtol=0, atol=CONF_TOL)


def ladder_both(tables, thresholds, costs, batch):
    (jo, js), (to, ts) = (serve_ladder(p, tables, thresholds, costs, batch)
                          for p in BOTH)
    same_result(jo, to)
    assert js == ts
    return to, ts


def test_threshold_above_one_collapses_tier():
    rows = 256
    labels, tables = planted_tiers(rows, seed=3)
    batch = {"idx": np.arange(rows)}
    out3, stats3 = ladder_both(tables, [0.7, 2.0, 0.0],
                               [0.0, 0.001, 0.005], batch)
    out2, _ = ladder_both([tables[0], tables[2]], [0.7, 0.0],
                          [0.0, 0.005], batch)
    assert stats3["t1"]["answered"] == 0
    assert np.array_equal(out3.prediction, out2.prediction)
    assert np.array_equal(out3.accepted, out2.accepted)
    assert np.array_equal(out3.stage_index == 0, out2.stage_index == 0)


def test_cumulative_hop_pricing():
    rows = 256
    labels, tables = planted_tiers(rows, seed=4)
    out, stats = ladder_both(tables, [0.9, 0.9, 0.0], [0.0, 0.001, 0.005],
                             {"idx": np.arange(rows)})
    assert stats["t2"]["requests"] > 0
    by_stage = {0: 0.0, 1: 0.001, 2: 0.001 + 0.005}
    expect = np.array([by_stage[int(s)] for s in out.stage_index])
    expect[~out.accepted & (out.stage_index != 2)] = 0.0
    assert np.allclose(out.cost[out.accepted], expect[out.accepted])
    assert stats["t1"]["cost"] == pytest.approx(
        0.001 * (stats["t1"]["answered"] + stats["t1"]["escalated"]))
    assert stats["t2"]["cost"] == pytest.approx(
        0.005 * stats["t2"]["requests"])


def test_device_tensor_batches_are_taken_where_they_lie():
    """A ladder fed tensors (as the port's remote tier is) takes each
    hop's residual rows with a tensor index, and answers as the numpy
    batch does."""
    rows = 64
    labels, tables = planted_tiers(rows, seed=9)
    ladder = [0.9, 0.9, 0.0], [0.0, 0.001, 0.005]
    tt = [torch.from_numpy(t) for t in tables]
    ref, _ = serve_ladder(TORCH, tables, *ladder, {"idx": np.arange(rows)})
    cascade = trt.TieredCascade(trt.build_stage_chain([
        dict(name=f"t{i}", config=quiet_tconf(TORCH),
             apply=lambda b, tbl=tbl: tbl[b["idx"]],
             cost_per_request=c, threshold=th)
        for i, (tbl, th, c) in enumerate(zip(tt, *ladder))]))
    out = cascade.serve({"idx": torch.arange(rows)})
    cascade.shutdown()
    same_result(ref, out)


# ------------------------------------------------------- engine paths

def engine_digest(p, terminal_stage: bool, rows: int = 128, seed: int = 5):
    def remote_apply(x):
        return 5.0 * np.asarray(x)

    cls = p.rt.CascadeStage if terminal_stage else p.rt.RemoteBackend
    router = p.rt.RemoteRouter([cls("cloud", remote_apply, quiet_tconf(p),
                                    cost_per_request=0.005)])
    engine = p.engine.CascadeEngine(
        p.local, batch_size=16, remote_fraction_budget=0.5, t_remote=0.0,
        transport=router,
        controller=p.rt.AdaptiveController(p.rt.ControllerConfig(
            target_remote_fraction=0.4, window=32)), **p.kw)
    sched = p.serving.MicrobatchScheduler(engine, fallback=lambda r: -7)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, rows)
    xs = np.float32(rng.normal(0, 0.05, (rows, 4)))
    xs[np.arange(rows), labels] += np.where(rng.random(rows) < 0.5,
                                            0.1, 3.0)
    for i, row in enumerate(xs):
        sched.submit(p.serving.Request(uid=i, local_input=row,
                                       remote_input=row))
    responses = sched.flush()
    engine.close()
    st, cs = engine.stats, engine.controller.state
    return {
        "responses": [(r.uid, int(r.prediction), r.source,
                       r.disposition, r.backend,
                       round(float(r.cost), 12)) for r in responses],
        "billing": {f: getattr(st, f) for f in p.engine.BILLING_FIELDS},
        "per_backend": {str(k): vars(v).copy()
                        for k, v in st.per_backend.items()},
        "controller": (cs.windows, cs.ema_fraction, cs.t_local,
                       cs.t_remote, cs.drift_events),
    }


def same_engine(j: dict, t: dict) -> None:
    """Engine digests: responses, billing and controller counts exact; the
    controller's threshold (a quantile of confidences) and the
    per-backend agreement EMA within CONF_TOL."""
    assert t["responses"] == j["responses"]
    assert t["billing"] == j["billing"]
    assert j["controller"][:2] == t["controller"][:2]
    assert j["controller"][3:] == t["controller"][3:]
    assert t["controller"][2] == pytest.approx(j["controller"][2],
                                               abs=CONF_TOL)
    assert set(j["per_backend"]) == set(t["per_backend"])
    for name, u in j["per_backend"].items():
        v = t["per_backend"][name]
        for k in u:
            if k == "agreement_ema" and u[k] is not None:
                assert v[k] == pytest.approx(u[k], abs=CONF_TOL)
            else:
                assert v[k] == u[k], (name, k)


def test_terminal_stage_engine_identity():
    """A terminal CascadeStage routed through the port's engine is
    bitwise-identical to its plain RemoteBackend path, and both match
    JAX's."""
    plain = engine_digest(TORCH, False)
    assert plain == engine_digest(TORCH, True)
    same_engine(engine_digest(JAX, False), plain)


def chained_run(p, tables, rows):
    chain = p.rt.build_stage_chain([
        dict(name="edge", apply=lut_apply(tables[1]),
             config=quiet_tconf(p), cost_per_request=0.001,
             threshold=0.9),
        dict(name="cloud", apply=lut_apply(tables[2]),
             config=quiet_tconf(p), cost_per_request=0.005),
    ])
    engine = p.engine.CascadeEngine(p.take(tables[0]), batch_size=16,
                                    remote_fraction_budget=1.0,
                                    t_remote=0.0,
                                    transport=p.rt.RemoteRouter([chain]),
                                    **p.kw)
    engine.t_local = 0.9
    sched = p.serving.MicrobatchScheduler(engine, fallback=lambda r: -7)
    for i in range(rows):
        sched.submit(p.serving.Request(uid=i, local_input=np.int64(i),
                                       remote_input={"idx": np.int64(i)}))
    responses = sched.flush()
    engine.close()
    st = engine.stats
    return {"responses": [(r.uid, int(r.prediction), r.source,
                           r.disposition, r.backend,
                           round(float(r.cost), 12)) for r in responses],
            "billing": {f: getattr(st, f) for f in p.engine.BILLING_FIELDS},
            "per_backend": {str(k): vars(v).copy()
                            for k, v in st.per_backend.items()},
            "controller": (0, 0, 0, 0, 0)}


def test_chained_stage_per_backend_split_and_agreement():
    rows = 256
    labels, tables = planted_tiers(rows, seed=6)
    got = chained_run(TORCH, tables, rows)
    same_engine(chained_run(JAX, tables, rows), got)
    st, per = got["billing"], got["per_backend"]
    assert set(per) == {"edge", "cloud"}
    assert per["edge"]["remote_calls"] > 0
    assert per["cloud"]["remote_calls"] > 0
    assert st["escalations"] == sum(
        u["remote_calls"] + u["cache_hits"] + u["transport_failures"]
        for u in per.values())
    assert abs(st["total_cost"]
               - sum(u["cost"] for u in per.values())) < 1e-12
    assert per["cloud"]["cost"] == pytest.approx(
        (0.001 + 0.005) * per["cloud"]["remote_calls"])
    assert {r[4] for r in got["responses"] if r[4]} <= {"edge", "cloud"}
    for u in per.values():
        assert u["agreement_ema"] is not None
        assert 0.0 <= u["agreement_ema"] <= 1.0
        assert u["agreement_rows"] > 0


# --------------------------------------------------- per-tier budgets

def test_tiered_budget_controller_reconciles():
    recs = {}
    for p in BOTH:
        tiered = p.rt.TieredBudgetController(
            {"device": 0.5, "edge": 0.5},
            base=p.rt.ControllerConfig(window=8), reconcile_every=2)
        assert tiered.global_target == pytest.approx(0.25)
        conf = np.linspace(0.1, 0.9, 8)
        for _ in range(12):
            tiered.observe("device", conf, escalated=6, requests=8)
            tiered.observe("edge", conf[:6], escalated=3, requests=6)
        assert tiered.reconciles > 0
        rec = tiered.reconcile()
        assert set(rec["targets"]) == {"device", "edge"}
        assert rec["observed"] > tiered.global_target
        assert rec["targets"]["device"] < 0.5
        assert rec["targets"]["edge"] < 0.5
        for name, t in rec["targets"].items():
            assert tiered.loop(name).config.target_remote_fraction == \
                pytest.approx(t)
        recs[p.name] = (rec, tiered.reconciles)
    assert recs["jax"] == recs["torch"]


def test_tiered_budget_controller_validates():
    for p in BOTH:
        with pytest.raises(ValueError):
            p.rt.TieredBudgetController({})


# ------------------------------------------------- serving config face

def test_tierspec_parse():
    for p in BOTH:
        TS = p.serving.TierSpec
        assert TS.parse("edge:0.001:0.1:0.6:entropy") == \
            TS("edge", 0.001, 0.1, 0.6, "entropy")
        assert TS.parse("cloud:0.0048") == \
            TS("cloud", 0.0048, None, 0.0, "max_softmax")
        assert TS.parse("edge::0.25::") == \
            TS("edge", None, 0.25, 0.0, "max_softmax")
        for bad in (":0.1", "a:1:2:3:4:5"):
            with pytest.raises(ValueError):
                TS.parse(bad)


def test_serveconfig_tiers_exclusive_and_overridable():
    for p in BOTH:
        cfg = p.serving.ServeConfig().with_overrides(
            ["tiers=edge:0.001:0.1:0.6;cloud:0.0048:0.8"])
        assert [t.name for t in cfg.tiers] == ["edge", "cloud"]
        assert cfg.tiers[0].threshold == 0.6
        with pytest.raises(ValueError):
            p.serving.ServeConfig(
                tiers=(p.serving.TierSpec("edge"),),
                remotes=({"name": "a", "cost_per_request": 0.1},))


def test_serveconfig_tiers_build_chained_router():
    rows = 64
    labels, tables = planted_tiers(rows, seed=8)
    out = {}
    for p in BOTH:
        cfg = p.serving.ServeConfig(tiers=(
            p.serving.TierSpec("edge", 0.001, None, 0.9),
            p.serving.TierSpec("cloud", 0.005)))
        router = cfg.build_router({"edge": lut_apply(tables[1]),
                                   "cloud": lut_apply(tables[2])})
        head = router.backends[0]
        assert isinstance(head, p.rt.CascadeStage)
        assert [s.name for s in head.chain()] == ["edge", "cloud"]
        logits, ok, detail = head.call_scored({"idx": np.arange(rows)}, 0)
        assert ok.all()
        assert set(np.unique(detail["stage"])) <= {"edge", "cloud"}
        head.shutdown()
        out[p.name] = (logits, detail)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    for k in ("stage", "cost", "latency"):
        np.testing.assert_array_equal(out["torch"][1][k], out["jax"][1][k])
    np.testing.assert_allclose(out["torch"][1]["conf"], out["jax"][1]["conf"],
                               rtol=0, atol=CONF_TOL)


# ------------------------------------------------------------- bench

def test_hierarchy_bench_checks_pass_in_the_port(monkeypatch):
    """``benchmarks.hierarchy_bench`` at 512 rows driven through the port's
    runtime: 3-tier dominance, replay, the degenerate 2-stage engine
    identity, billing reconciliation and every other hard check pass,
    and the tiered runtime phase serves as JAX's does."""
    from benchmarks import hierarchy_bench as bench

    want = bench.run(verbose=False, rows=512, grid=7, seed=7, json_path=None)
    with monkeypatch.context() as m:
        port_swap(m, bench)
        assert bench.TieredCascade is trt.TieredCascade
        got = bench.run(verbose=False, rows=512, grid=7, seed=7,
                        json_path=None)
    assert got["passed"], got["checks"]
    assert got["checks"] == want["checks"]
    rt_j, rt_t = want["runtime"], got["runtime"]
    for k in ("rows", "system_accuracy", "rejection_rate",
              "cost_per_request", "stage_mix", "stage_stats"):
        assert rt_t[k] == rt_j[k], k
    assert got["engine_identity"] == want["engine_identity"]
    for k in ("billing", "backends_seen", "escalation_identity",
              "cost_reconciles"):
        assert got["engine_chained"][k] == want["engine_chained"][k], k
