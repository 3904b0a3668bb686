"""The replica cluster in the PyTorch port against the JAX package: the
counterparts of ``tests/test_cluster.py``, and the hard checks of
``benchmarks/cluster_bench.py`` at a short duration.

Each test runs the same scenario in both packages (the port on the CPU)
and asserts what the JAX test asserts on the port's result, and that both
agree: the shared cache's fill feed, claims and statistics, the budget
reconcile's mode, threshold and targets, and every response and billing
field of a ``ClusterHarness`` run. The local tier is ``x + 0.3 sin(17 x)``
in float32 in both packages, and its confidences differ between them by
~1e-7; the reconcile's pooled threshold, a quantile of those
confidences, is compared within 1e-6, and everything else exactly.
"""

from __future__ import annotations

import threading
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
from tests.test_torch_chaos import port_swap  # noqa: E402

TAU_TOL = 1e-6

JAX = SimpleNamespace(name="jax", rt=jrt, serving=jserving, engine=jengine,
                      local=lambda x: x + 0.3 * jnp.sin(17.0 * x), kw={})
TORCH = SimpleNamespace(name="torch", rt=trt, serving=tserving,
                        engine=tengine,
                        local=lambda x: x + 0.3 * torch.sin(17.0 * x),
                        kw={"device": "cpu"})
BOTH = (JAX, TORCH)


def remote_fn(x):
    return 5.0 * np.asarray(x)


def make_stream(rng, n, c=4, hard_frac=0.5):
    labels = rng.integers(0, c, n)
    x = rng.normal(0, 0.05, (n, c))
    margin = np.where(rng.random(n) < hard_frac, 0.1, 3.0)
    x[np.arange(n), labels] += margin
    return np.float32(x), labels


def fresh_controller(p, *, window=32, target=0.25):
    return p.rt.AdaptiveController(p.rt.ControllerConfig(
        target_remote_fraction=target, window=window,
        drift_threshold=10.0, history=4096))


def feed(ctrl, scores):
    scores = np.asarray(scores, np.float64)
    ctrl.observe(scores, escalated=int((scores < 0.5).sum()),
                 requests=scores.size)
    return ctrl


def state_of(st) -> dict:
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in vars(st).items()}


# ----------------------------------------------------- shared cache

def test_shared_cache_single_fill_and_attribution():
    def run(p):
        sc = p.rt.SharedResponseCache(capacity=8)
        a, b = sc.view("a"), sc.view("b")
        val = np.arange(4.0)
        key = sc.key_fn(val)
        assert a.lookup(key) is None and a.lookup(key) is None
        a.put(key, val, source="primary")
        hit = b.lookup(key)
        np.testing.assert_array_equal(hit[0], val)
        assert hit[1] == "primary"
        assert b.stats.cross_hits == 1 and a.stats.cross_hits == 0
        assert sc.stats.fills == 1 and sc.stats.duplicate_fills == 0
        b.put(key, val * 10, source="secondary")
        assert sc.stats.duplicate_fills == 1
        np.testing.assert_array_equal(a.lookup(key)[0], val)
        return (key, vars(sc.stats), vars(a.stats), vars(b.stats),
                p.rt.SharedResponseCache.materialize(sc.feed))

    j, t = (run(p) for p in BOTH)
    assert j == t


def test_shared_cache_concurrent_misses_one_owner():
    def run(p):
        sc = p.rt.SharedResponseCache(capacity=8, wait_s=10.0)
        owner = sc.view("owner")
        val = np.float32([1.0, 2.0])
        key = sc.key_fn(val)
        assert owner.lookup(key) is None
        results = {}

        def peer(name):
            results[name] = sc.view(name).lookup(key)

        threads = [threading.Thread(target=peer, args=(f"p{i}",))
                   for i in range(3)]
        for t in threads:
            t.start()
        while sc.stats.waits < 3:           # every peer is parked
            pass
        owner.put(key, val, source="primary")
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        for name in ("p0", "p1", "p2"):
            np.testing.assert_array_equal(results[name][0], val)
            assert results[name][1] == "primary"
        assert sc.stats.fills == 1 and sc.stats.duplicate_fills == 0
        assert sum(sc.view(f"p{i}").stats.cross_hits for i in range(3)) == 3
        return vars(sc.stats)

    j, t = (run(p) for p in BOTH)
    assert j == t and t["waits"] == 3


def test_shared_cache_release_unfilled_hands_claim_over():
    def run(p):
        sc = p.rt.SharedResponseCache(capacity=8, wait_s=10.0)
        val = np.float32([3.0])
        key = sc.key_fn(val)
        assert sc.view("dead").lookup(key) is None
        got = {}

        def peer():
            got["hit"] = sc.view("heir").lookup(key)

        t = threading.Thread(target=peer)
        t.start()
        while sc.stats.waits == 0:
            pass
        released = sc.release_unfilled("dead")
        t.join(timeout=10.0)
        assert got["hit"] is None
        sc.view("heir").put(key, val, source="s")
        return released, vars(sc.stats), [
            (u.seq, u.key, u.source, u.replica) for u in sc.feed]

    j, t = (run(p) for p in BOTH)
    assert j == t
    assert t[0] == 1 and t[1]["fills"] == 1 and t[1]["releases"] == 1


def test_shared_cache_materialize_is_permutation_invariant():
    def run(p):
        sc = p.rt.SharedResponseCache(capacity=32)
        for i in range(6):
            v = np.float32([i, i + 1])
            k = sc.key_fn(v)
            assert sc.view(f"r{i % 2}").lookup(k) is None
            sc.view(f"r{i % 2}").put(k, v, source=f"b{i % 3}")
        feed = list(sc.feed)
        base = p.rt.SharedResponseCache.materialize(feed)
        rng = np.random.default_rng(0)
        for _ in range(5):
            perm = [feed[j] for j in rng.permutation(len(feed))]
            assert p.rt.SharedResponseCache.materialize(perm) == base
        return base

    j, t = (run(p) for p in BOTH)
    assert j == t


# ------------------------------------------------- budget reconcile

def same_state(j, t) -> None:
    """Reconcile states: mode, targets, stale set and counts exact; the
    pooled threshold within TAU_TOL."""
    j, t = state_of(j), state_of(t)
    jt, tt = j.pop("tau"), t.pop("tau")
    assert (jt is None) == (tt is None)
    if jt is not None:
        assert tt == pytest.approx(jt, abs=TAU_TOL)
    assert j == t


def test_reconcile_pooled_holds_global_budget_under_skew():
    def run(p):
        rng = np.random.default_rng(1)
        hard = rng.uniform(0.0, 0.5, 200)
        easy = rng.uniform(0.5, 1.0, 200)
        cl = p.rt.ClusterBudgetController(p.rt.ClusterBudgetConfig(
            target_remote_fraction=0.25, min_pooled_scores=64))
        r0, r1 = fresh_controller(p), fresh_controller(p)
        cl.register("r0", r0)
        cl.register("r1", r1)
        feed(r0, hard)
        feed(r1, easy)
        st = cl.reconcile(now=1.0)
        assert st.mode == "pooled" and st.tau is not None
        assert st.targets["r0"] > 0.4 and st.targets["r1"] < 0.1
        mean = (st.targets["r0"] * 200 + st.targets["r1"] * 200) / 400
        assert mean == pytest.approx(0.25, abs=0.021)
        assert (cl._replicas["r0"].config.target_remote_fraction
                == st.targets["r0"])
        assert cl.admission_scale("r1") < 1.0 < cl.admission_scale("r0")
        assert 0.25 <= cl.admission_scale("r1") <= 4.0
        return st, (cl.admission_scale("r0"), cl.admission_scale("r1"))

    (js, ja), (ts, ta) = (run(p) for p in BOTH)
    same_state(js, ts)
    assert ja == ta


def test_reconcile_blackout_replica_degrades_to_base_budget():
    def run(p):
        rng = np.random.default_rng(2)
        cl = p.rt.ClusterBudgetController(p.rt.ClusterBudgetConfig(
            target_remote_fraction=0.3, min_pooled_scores=64))
        up0, up1 = (fresh_controller(p, target=0.3) for _ in range(2))
        dead = fresh_controller(p, target=0.3)
        cl.register("up0", up0)
        cl.register("up1", up1)
        cl.register("dead", dead)
        feed(up0, rng.uniform(0, 1, 150))
        feed(up1, rng.uniform(0, 1, 150))
        st = cl.reconcile(now=1.0)
        assert st.mode == "pooled" and st.stale == ("dead",)
        assert st.targets["dead"] == 0.3
        assert dead.config.target_remote_fraction == 0.3
        cl2 = p.rt.ClusterBudgetController(p.rt.ClusterBudgetConfig(
            target_remote_fraction=0.3))
        solo = fresh_controller(p, target=0.3)
        cl2.register("solo", solo)
        feed(solo, rng.uniform(0, 1, 150))
        st2 = cl2.reconcile(now=1.0)
        assert st2.mode == "degraded" and st2.targets["solo"] == 0.3
        return st, st2

    (j1, j2), (t1, t2) = (run(p) for p in BOTH)
    same_state(j1, t1)
    same_state(j2, t2)


def test_reconcile_is_registration_order_invariant():
    def run(p):
        rng = np.random.default_rng(3)
        pools = {f"r{i}": rng.uniform(0, 1, 100 + 40 * i) for i in range(4)}
        states = []
        for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
            cl = p.rt.ClusterBudgetController(p.rt.ClusterBudgetConfig(
                target_remote_fraction=0.25, min_pooled_scores=64))
            ctrls = {}
            for i in order:
                ctrls[i] = fresh_controller(p)
                cl.register(f"r{i}", ctrls[i])
            for i in order:
                feed(ctrls[i], pools[f"r{i}"])
            states.append(state_of(cl.reconcile(now=1.0)))
        for st in states[1:]:
            assert st == states[0]                      # bitwise
        return states[0]

    j, t = (run(p) for p in BOTH)
    assert j == t       # same float64 scores fed: the threshold too


def test_cluster_billing_is_merge_order_invariant():
    class U:
        def __init__(self, c):
            self.remote_calls, self.cache_hits = c, c + 1
            self.transport_failures, self.cost = c % 2, 0.1 * c + 0.007
            self.remote_latency_s = 0.003 * c

    class St:
        def __init__(self, c):
            for i, f in enumerate(tengine.BILLING_FIELDS):
                setattr(self, f, c + 0.1 * i if f == "total_cost" else
                        c + i)
            self.per_backend = {"a": U(c), "b": U(c + 3)}

    stats = {f"r{i}": St(i) for i in range(5)}
    base = trt.cluster_billing(stats)
    assert base == jrt.cluster_billing(stats)
    for order in ([4, 2, 0, 3, 1], [1, 0, 4, 2, 3]):
        shuffled = {f"r{i}": stats[f"r{i}"] for i in order}
        assert trt.cluster_billing(shuffled) == base    # bitwise


# --------------------------------------------------------- harness

def make_router(p, clock):
    tconf = p.rt.TransportConfig(max_in_flight=16, max_retries=0,
                                 retry_backoff_s=0.0, timeout_s=10.0,
                                 breaker_failures=10**6)
    return p.rt.RemoteRouter(
        [p.rt.RemoteBackend("primary", remote_fn, tconf,
                            cost_per_request=0.002, latency_s=0.01,
                            clock=clock, sleep=clock.sleep)])


def drive_harness(p, seed=0, replicas=2, n=96):
    clock = p.rt.VirtualClock()
    cfg = p.serving.ServeConfig(batch_size=8, remote_fraction_budget=0.25,
                                t_remote=0.0, pipeline_depth=1,
                                cache_size=256, adaptive=True,
                                control_window=16, replicas=replicas,
                                observability=True)
    h = p.rt.ClusterHarness(cfg, p.local, transport=make_router(p, clock),
                            fallback=lambda r: -1, clock=clock, seed=seed,
                            reconcile_interval_s=0.5, **p.kw)
    rng = np.random.default_rng(7)
    xs, labels = make_stream(rng, n)
    proto = xs[rng.integers(0, 24, n)]      # repeats -> cache traffic
    responses = []
    for i in range(n):
        clock.advance_to(0.05 * i)
        h.submit(h.names[i % replicas],
                 p.serving.Request(uid=i, local_input=proto[i],
                                   remote_input=proto[i]))
        if (i + 1) % (8 * replicas) == 0:
            for batch in h.flush().values():
                responses.extend(batch)
    for batch in h.flush().values():
        responses.extend(batch)
    digest = {
        "responses": [(r.uid, int(r.prediction), r.source,
                       r.disposition, r.backend, round(r.cost, 12))
                      for r in sorted(responses, key=lambda r: r.uid)],
        "billing": h.global_billing(),
        "feed": [(u.key.hex(), u.source, u.replica)
                 for u in h.shared_cache.feed],
        "reconciles": h.cluster.state.reconciles,
        "targets": dict(h.cluster.state.targets),
        "events": dict(sorted(h.events.counts().items())),
        "cross_hits": {name: h.replica(name).cache.stats.cross_hits
                       for name in h.names},
    }
    h.close()
    return h, digest, n


def test_harness_double_run_is_bit_identical():
    h1, d1, n = drive_harness(TORCH, seed=3)
    h2, d2, _ = drive_harness(TORCH, seed=3)
    assert d1 == d2
    _, dj, _ = drive_harness(JAX, seed=3)
    assert d1 == dj                     # every response and billing field
    uids = [r[0] for r in d1["responses"]]
    assert sorted(uids) == list(range(n))
    assert h1.shared_cache.stats.duplicate_fills == 0
    keys = [k for k, _, _ in d1["feed"]]
    assert len(keys) == len(set(keys))
    assert sum(d1["cross_hits"].values()) > 0
    assert d1["reconciles"] > 0
    assert "cluster_reconcile" in d1["events"]
    scs = h1.shared_cache.stats
    b = d1["billing"]["billing"]
    assert b["remote_calls"] == scs.fills + scs.redundant_puts
    assert b["requests"] == n


def test_harness_admission_share_scales_soft_watermark():
    def run(p):
        clock = p.rt.VirtualClock()
        cfg = p.serving.ServeConfig(
            batch_size=8, remote_fraction_budget=0.25, t_remote=0.0,
            pipeline_depth=1, cache_size=0, adaptive=True,
            control_window=16, replicas=2, admission_limit=40,
            admission_soft_ratio=0.5, observability=True)
        h = p.rt.ClusterHarness(cfg, p.local,
                                transport=make_router(p, clock),
                                fallback=lambda r: -1, clock=clock, **p.kw)
        sched = h.replica("r0").scheduler
        seen = [sched._soft_watermark(), sched.admission_soft]
        h.cluster.state.global_target = 0.25
        h.cluster.state.targets = {"r0": 0.125, "r1": 0.375}
        seen.append(sched._soft_watermark())
        h.cluster.state.targets = {"r0": 10.0, "r1": 0.375}
        seen.append(sched._soft_watermark())
        h.close()
        return seen

    seen = run(TORCH)
    assert seen == run(JAX)
    assert seen[0] == seen[1]                   # share 1.0
    assert seen[2] == 10                        # squeezed: sheds early
    assert seen[3] == 40 - 1                    # capped below the hard limit


def test_serveconfig_cluster_validation():
    for p in BOTH:
        SC = p.serving.ServeConfig
        with pytest.raises(ValueError, match="adaptive"):
            SC(replicas=2)
        with pytest.raises(ValueError, match="fused"):
            SC(fused=True, replicas=2, adaptive=True)
        with pytest.raises(ValueError, match="fused"):
            SC(fused=True, data_parallel=True)
        assert SC(replicas=3, adaptive=True).replicas == 3


def test_data_parallel_is_refused_until_the_mesh_is_ported():
    """JAX shards the local step over a serving mesh (a numeric no-op on
    one device); the port now has one (``launch.mesh.make_serving_mesh``)
    and takes the option as JAX does, alone and beside replicas; only
    the fused path refuses it (``test_serveconfig_cluster_validation``)."""
    for kw in ({"data_parallel": True},
               {"data_parallel": True, "replicas": 2, "adaptive": True}):
        assert jserving.ServeConfig(**kw).data_parallel
        assert tserving.ServeConfig(**kw).data_parallel


# ------------------------------------------------------------- bench

def test_cluster_bench_checks_pass_in_the_port(monkeypatch):
    """``benchmarks.cluster_bench`` (4 replicas, skewed diurnal trace,
    shared two-backend router under chaos) at a 20 s virtual duration,
    driven through the port's runtime: replay, single fill, the global
    budget within its tolerance and zero silent drops hold, every check
    comes out as in the JAX run, and the digest the replay check
    compares (every response, per-replica billing field, fill-feed
    record, reconcile and chaos count) equals JAX's."""
    from benchmarks import cluster_bench as bench
    from benchmarks.loadgen import generate_trace

    dur, seed = 20.0, 7
    trace = generate_trace(seed, pattern="diurnal", rate=bench.BASE_RATE,
                           peak_rate=bench.PEAK_RATE, duration_s=dur,
                           hard_frac=bench.HARD_FRAC)
    xs, assign = bench.make_workload(trace, seed)
    want_report = bench.run(verbose=False, duration_s=dur, seed=seed,
                            json_path=None, events_jsonl=None)
    want = bench._digest(bench.drive(trace, xs, assign, seed))
    with monkeypatch.context() as m:
        port_swap(m, bench)
        got = bench._digest(bench.drive(trace, xs, assign, seed))
        report = bench.run(verbose=False, duration_s=dur, seed=seed,
                           json_path=None, events_jsonl=None)
    checks = report["checks"]
    for name in ("deterministic_replay", "single_fill",
                 "global_budget_holds", "zero_silent_drop"):
        assert checks[name], (name, checks)
    assert checks == want_report["checks"]
    rec_j, rec_t = want.pop("reconciles"), got.pop("reconciles")
    assert [r[:2] + r[3:] for r in rec_t] == [r[:2] + r[3:] for r in rec_j]
    np.testing.assert_allclose(np.array([r[2] for r in rec_t], float),
                               np.array([r[2] for r in rec_j], float),
                               rtol=0, atol=TAU_TOL)
    assert got == want
