"""Chaos injection and overload admission in the PyTorch port against the
JAX package: the counterparts of ``tests/test_chaos.py``.

Each test runs the same scenario through both packages (the port on the
CPU) and asserts what the JAX test asserts on the port's result, and that
both packages agree: the same ``ChaosSchedule`` and seed inject into the
same call indices and episodes, the virtual clock, breaker transitions,
event order and backoff sleeps are equal, and every response and billing
field of the engine runs is equal. The local tier is ``x + 0.3 sin(17 x)``
in float32 in both packages; its confidences differ between them by
~1e-7, far inside the gaps of these streams (each engine test checks that
both packages escalate the same rows, which such a difference would
break first).

``test_streaming_and_fifo_bill_identically_under_chaos`` runs its
transport with one pool worker. With several, two pipelined windows reach
the chaos wrapper from two pool threads in whichever order the threads
run, and the count-indexed draws then land on other windows
(``test_concurrent_windows_draw_in_arrival_order`` shows it): that is why
the JAX test of that name fails now and then under a loaded host.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import random
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime as jrt  # noqa: E402
import repro.runtime.transport as jtransport  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro.serving.engine as jengine  # noqa: E402
import repro.serving.policy as jpolicy  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
import repro_torch.runtime.transport as ttransport  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
import repro_torch.serving.engine as tengine  # noqa: E402
import repro_torch.serving.policy as tpolicy  # noqa: E402
from repro.runtime.observability import EventLog as JEventLog  # noqa: E402
from repro_torch.runtime.observability import EV_CLUSTER_RECONCILE  # noqa: E402
from repro_torch.runtime.observability import EventLog as TEventLog  # noqa: E402


def jax_local(x):
    return x + 0.3 * jnp.sin(17.0 * x)


def torch_local(x):
    return x + 0.3 * torch.sin(17.0 * x)


def remote_apply(x):
    return 5.0 * np.asarray(x)


JAX = SimpleNamespace(name="jax", rt=jrt, transport=jtransport,
                      serving=jserving, engine=jengine, policy=jpolicy,
                      EventLog=JEventLog, local=jax_local, kw={})
TORCH = SimpleNamespace(name="torch", rt=trt, transport=ttransport,
                        serving=tserving, engine=tengine, policy=tpolicy,
                        EventLog=TEventLog, local=torch_local,
                        kw={"device": "cpu"})
BOTH = (JAX, TORCH)


def both(fn, *args, **kw):
    """``fn(pkg, ...)`` for JAX then the port; asserts the two results
    are equal and returns the port's."""
    j, t = (fn(p, *args, **kw) for p in BOTH)
    assert j == t, (j, t)
    return t


def make_stream(rng, n, c=4, hard_frac=0.5):
    labels = rng.integers(0, c, n)
    x = rng.normal(0, 0.05, (n, c))
    margin = np.where(rng.random(n) < hard_frac, 0.1, 3.0)
    x[np.arange(n), labels] += margin
    return np.float32(x), labels


def quiet_tconf(p, **kw):
    base = dict(retry_backoff_s=0.0, max_retries=0,
                breaker_failures=10**6, timeout_s=60.0)
    base.update(kw)
    return p.rt.TransportConfig(**base)


def responses_digest(responses) -> list:
    return [(r.uid, int(r.prediction), r.source, r.disposition, r.backend,
             round(float(r.cost), 12))
            for r in sorted(responses, key=lambda r: r.uid)]


def billing_digest(p, stats) -> dict:
    return {"billing": {f: getattr(stats, f)
                        for f in p.engine.BILLING_FIELDS},
            "per_backend": {str(k): vars(v).copy()
                            for k, v in stats.per_backend.items()}}


# ------------------------------------------------------------ chaos core

def test_episode_validation_and_defaults():
    def run(p):
        ep = p.rt.ChaosEpisode("outage", 2.0, 3.0)
        assert ep.name == "outage@2" and ep.end_s == 5.0
        assert ep.covers("any", 2.0) and not ep.covers("any", 5.0)
        assert ep.progress(3.5) == 0.5
        scoped = p.rt.ChaosEpisode("outage", 0.0, 1.0, backends=("a",))
        assert scoped.covers("a", 0.5) and not scoped.covers("b", 0.5)
        errors = []
        for kw in (dict(kind="meteor", start_s=0.0, duration_s=1.0),
                   dict(kind="outage", start_s=0.0, duration_s=0.0),
                   dict(kind="brownout", start_s=0.0, duration_s=1.0,
                        rate=1.5)):
            with pytest.raises(ValueError) as e:
                p.rt.ChaosEpisode(**kw)
            errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            p.rt.ChaosSchedule([
                p.rt.ChaosEpisode("outage", 0.0, 1.0, name="x"),
                p.rt.ChaosEpisode("flap", 2.0, 1.0, name="x")])
        errors.append(str(e.value))
        return (ep.name, ep.end_s, p.rt.CHAOS_KINDS, errors)

    both(run)


def test_virtual_clock_sleep_advances_and_never_rewinds():
    def run(p):
        clk = p.rt.VirtualClock(5.0)
        clk.sleep(0.25)
        seen = [clk()]
        clk.advance_to(4.0)             # never backwards
        seen.append(clk())
        clk.sleep(-1.0)                 # negative sleep is a no-op
        seen.append(clk())
        return seen

    assert both(run) == [5.25, 5.25, 5.25]


def test_wrap_is_idempotent_and_faults_are_tagged():
    def run(p):
        clk = p.rt.VirtualClock()
        t = p.rt.RemoteTransport(remote_apply, quiet_tconf(p), clock=clk,
                                 sleep=clk.sleep)
        sched = p.rt.ChaosSchedule([p.rt.ChaosEpisode("outage", 0.0, 1.0,
                                                      name="ep-tag")])
        sched.wrap_transport(t, "b")
        assert isinstance(t.remote_apply, p.rt.ChaosRemote)
        with pytest.raises(ValueError):
            sched.wrap_transport(t, "b")
        with pytest.raises(p.rt.ChaosFault, match=r"chaos\[ep-tag\]") as e:
            t.remote_apply(np.zeros((1, 2), np.float32))
        return str(e.value), dict(sched.stats.by_episode)

    assert both(run)[1] == {"ep-tag": 1}


def brownout_draws(p, backend, seed, n=64):
    clk = p.rt.VirtualClock(0.5)
    t = p.rt.RemoteTransport(remote_apply, quiet_tconf(p), clock=clk,
                             sleep=clk.sleep)
    sched = p.rt.ChaosSchedule([p.rt.ChaosEpisode("brownout", 0.0, 10.0,
                                                  rate=0.4, name="b")],
                               seed=seed)
    sched.wrap_transport(t, backend)
    out = []
    x = np.zeros((1, 2), np.float32)
    for _ in range(n):
        try:
            t.remote_apply(x)
            out.append(False)
        except p.rt.ChaosFault:
            out.append(True)
    return out


def test_brownout_draws_are_seeded_per_backend_and_replayable():
    """The same (seed, episode, backend) injects into the same call
    indices in both packages; another backend name or seed draws an
    independent stream."""
    for p in BOTH:
        assert p.rt.ChaosSchedule([], seed=3).stream_seed(
            p.rt.ChaosEpisode("brownout", 0.0, 1.0, name="b"), "alpha") \
            == trt.ChaosSchedule([], seed=3).stream_seed(
                trt.ChaosEpisode("brownout", 0.0, 1.0, name="b"), "alpha")
    a = both(brownout_draws, "alpha", seed=3)
    assert a == brownout_draws(TORCH, "alpha", seed=3)   # replay
    assert a != both(brownout_draws, "beta", seed=3)     # per backend
    assert a != both(brownout_draws, "alpha", seed=4)    # per seed
    assert any(a) and not all(a)                         # partial


def test_latency_ramp_and_timeout_storm_drive_virtual_clock():
    def run(p):
        clk = p.rt.VirtualClock()
        t = p.rt.RemoteTransport(remote_apply, quiet_tconf(p), clock=clk,
                                 sleep=clk.sleep)
        sched = p.rt.ChaosSchedule([
            p.rt.ChaosEpisode("latency_ramp", 0.0, 10.0,
                              extra_latency_s=1.0, name="ramp"),
            p.rt.ChaosEpisode("timeout_storm", 20.0, 5.0,
                              extra_latency_s=0.5, name="storm")])
        sched.wrap_transport(t, "b")
        x = np.zeros((1, 2), np.float32)
        clk.advance_to(5.0)                     # mid-ramp: 50% of 1.0s
        t.remote_apply(x)
        seen = [clk()]
        clk.advance_to(21.0)
        with pytest.raises(p.rt.ChaosTimeout, match=r"chaos\[storm\]"):
            t.remote_apply(x)
        seen.append(clk())
        return seen, vars(sched.stats)

    seen, stats = both(run)
    assert seen == [pytest.approx(5.5), pytest.approx(21.5)]
    assert stats["delayed"] == 2
    assert stats["extra_latency_s"] == pytest.approx(1.0)


# ------------------------------------- breaker property-style coverage

def test_breaker_never_stuck_open_under_seeded_flapping():
    def run(p):
        clk = p.rt.VirtualClock()
        t = p.rt.RemoteTransport(
            remote_apply, quiet_tconf(p, breaker_failures=1,
                                      breaker_reset_s=0.5),
            clock=clk, sleep=clk.sleep)
        sched = p.rt.ChaosSchedule([p.rt.ChaosEpisode(
            "flap", 0.0, 8.0, period_s=1.0, name="f")], seed=1)
        sched.wrap_transport(t, "b")
        x = np.zeros((2, 2), np.float32)
        states = []
        for step in range(40):                  # 0.25s steps across chaos
            clk.advance_to(0.25 * step)
            t.call(x)
            states.append(t.breaker.state)
        clk.advance_to(sched.episodes[0].end_s + 0.6)
        logits, ok = t.call(x)
        return states, bool(ok.all()), t.breaker.state, vars(sched.stats)

    states, ok, final, _ = both(run)
    assert ttransport.OPEN in states            # the flap really bit
    assert ok and final == ttransport.CLOSED


def test_single_half_open_probe_and_probe_grant():
    def run(p):
        now = {"t": 0.0}
        b = p.transport.CircuitBreaker(1, reset_s=1.0,
                                       clock=lambda: now["t"])
        b.record_failure()
        seen = [b.state, b.try_probe()]
        now["t"] = 1.5
        seen += [b.try_probe(), b.state, b.try_probe(), b.would_allow()]
        b.record_success()
        return seen + [b.state]

    assert both(run) == [ttransport.OPEN, False, True, ttransport.HALF_OPEN,
                         False, False, ttransport.CLOSED]


def test_router_pick_emits_half_open_before_failback():
    def run(p):
        clk = p.rt.VirtualClock()

        def mk(name, cost):
            return p.rt.RemoteBackend(
                name, remote_apply,
                quiet_tconf(p, breaker_failures=1, breaker_reset_s=0.5),
                cost_per_request=cost, clock=clk, sleep=clk.sleep)

        primary, secondary = mk("primary", 0.001), mk("secondary", 0.01)
        router = p.rt.RemoteRouter([primary, secondary],
                                   policy="cheapest-available")
        ev = p.EventLog(256, clock=clk)
        router.events = ev
        for b in router.backends:
            b.transport.events = ev
            b.transport.event_source = b.name
        primary.transport.breaker.record_failure()
        ev.emit("breaker_open", backend="primary")
        first = router.pick(window=1).name
        clk.advance_to(1.0)
        second = router.pick(window=2).name
        return (first, second, primary.transport.breaker.state,
                ev.first_seq("breaker_half_open", "primary"),
                ev.first_seq("router_failover"),
                ev.first_seq("router_failback"))

    first, second, state, half, failover, failback = both(run)
    assert (first, second) == ("secondary", "primary")
    assert state == ttransport.HALF_OPEN
    assert half is not None and failback is not None
    assert failover < half < failback


# ------------------------------------------------- transport satellites

def test_bounded_attempt_abandons_hung_remote():
    def run(p):
        def hung(x):
            time.sleep(0.30)            # well past the 50ms deadline
            return remote_apply(x)

        t = p.rt.RemoteTransport(hung, quiet_tconf(p, timeout_s=0.05,
                                                   breaker_failures=1))
        t0 = time.perf_counter()
        logits, ok = t.call(np.zeros((2, 2), np.float32))
        elapsed = time.perf_counter() - t0
        t.shutdown(wait=False)          # must not block on the straggler
        assert elapsed < 0.25, (p.name, elapsed)
        return logits is None, bool(ok.any()), t.stats.timeouts, \
            t.breaker.state

    assert both(run) == (True, False, 1, ttransport.OPEN)


def test_backoff_capped_exponential_with_deterministic_jitter():
    def sleeps(p, seed):
        out = []
        t = p.rt.RemoteTransport(
            lambda x: (_ for _ in ()).throw(RuntimeError("down")),
            p.rt.TransportConfig(max_retries=4, retry_backoff_s=0.01,
                                 retry_backoff_cap_s=0.04,
                                 retry_jitter_seed=seed,
                                 breaker_failures=10**6, timeout_s=60.0),
            sleep=lambda dt: out.append(dt))
        t.call(np.zeros((1, 2), np.float32))
        return out

    a = both(sleeps, 0)
    assert len(a) == 4
    for got, raw in zip(a, [0.01, 0.02, 0.04, 0.04]):
        assert 0.5 * raw <= got < raw
    assert a != both(sleeps, 1)


# ------------------------------------------- admission control (shed)

def mk_stack(p, *, batch=8, limit=0, soft=0.5, depth=2, mode="fifo",
             default_policy=None):
    t = p.rt.RemoteTransport(remote_apply, quiet_tconf(p))
    engine = p.engine.CascadeEngine(p.local, batch_size=batch,
                                    remote_fraction_budget=0.5,
                                    t_remote=0.0, transport=t,
                                    default_policy=default_policy, **p.kw)
    sched = p.serving.MicrobatchScheduler(engine, fallback=lambda r: -7,
                                          pipeline_depth=depth,
                                          completion_mode=mode,
                                          admission_limit=limit,
                                          admission_soft_ratio=soft)
    return sched, engine


def submit_all(p, sched, xs, policies=None):
    for i, row in enumerate(xs):
        pol = policies[i] if policies is not None else None
        sched.submit(p.serving.Request(uid=i, local_input=row,
                                       remote_input=row, policy=pol))


def test_admission_needs_runtime_path():
    def run(p):
        engine = p.engine.CascadeEngine(p.local, remote_apply, batch_size=8,
                                        remote_fraction_budget=0.5,
                                        t_remote=0.0, **p.kw)
        with pytest.raises(ValueError, match="admission") as e:
            p.serving.MicrobatchScheduler(engine, admission_limit=4)
        engine.close()
        return str(e.value)

    both(run)


def test_queue_full_always_sheds_and_soft_watermark_splits():
    rng = np.random.default_rng(5)
    xs, _ = make_stream(rng, 40)

    def run(p):
        pols = [p.serving.RequestPolicy(on_miss="reject") if i % 3 == 0
                else None for i in range(40)]
        sched, engine = mk_stack(p, batch=8, limit=16, soft=0.5)
        submit_all(p, sched, xs, pols)
        ad = sched.admission
        responses = sched.flush()
        engine.close()
        st = engine.stats
        assert sorted(r.uid for r in responses) == list(range(40))
        shed = [r for r in responses if r.disposition == p.policy.SHED]
        assert len(shed) == ad.shed
        assert all(r.cost == 0.0 and r.source == "shed" for r in shed)
        assert ad.submitted == st.requests + ad.shed
        assert st.escalations == (st.remote_calls + st.cache_hits
                                  + st.transport_failures)
        return (vars(ad).copy(), responses_digest(responses),
                billing_digest(p, st))

    ad, _, _ = both(run)
    assert ad["submitted"] == 40 and ad["admitted"] == 16
    assert ad["shed_reasons"]["queue_full"] == 20
    assert ad["shed_reasons"]["overload"] > 0 and ad["degraded"] > 0


def test_shed_decisions_deterministic_across_runs():
    rng = np.random.default_rng(6)
    xs, _ = make_stream(rng, 64)

    def run(p):
        pols = [p.serving.RequestPolicy(on_miss="reject") if i % 4 == 0
                else None for i in range(64)]
        sched, engine = mk_stack(p, batch=8, limit=24, soft=0.5)
        submit_all(p, sched, xs, pols)
        resp = sched.flush()
        engine.close()
        return ([(r.uid, r.disposition) for r in
                 sorted(resp, key=lambda r: r.uid)],
                dict(sched.admission.shed_reasons))

    a = both(run)
    assert a == run(TORCH)              # same queue-depth trajectory
    assert any(d == tpolicy.SHED for _, d in a[0])


def test_deadline_feasibility_uses_service_ema():
    def run(p):
        sched, engine = mk_stack(p, batch=8, limit=64, soft=1.0)
        engine.stats.window_service_ema_s = 0.5     # queue wait >= 0.5s
        row = np.zeros((4,), np.float32)
        RP, Rq = p.serving.RequestPolicy, p.serving.Request
        r = sched.submit(Rq(uid=0, local_input=row, remote_input=row,
                            policy=RP(deadline_s=0.1, on_miss="reject")))
        seen = [r.disposition, dict(sched.admission.shed_reasons)]
        sched.submit(Rq(uid=1, local_input=row, remote_input=row,
                        policy=RP(deadline_s=0.1)))
        seen.append(dict(sched.admission.degrade_reasons))
        sched.submit(Rq(uid=2, local_input=row, remote_input=row,
                        policy=RP(deadline_s=0.1, escalation="never")))
        seen.append(sched.admission.degraded)       # no-op degrade skipped
        responses = sched.flush()
        engine.close()
        return seen, responses_digest(responses)

    seen, resp = both(run)
    assert seen == [tpolicy.SHED, {"deadline": 1}, {"deadline": 1}, 1]
    assert [r[0] for r in resp] == [0, 1, 2]


def chaos_serve(p, mode, xs, *, workers):
    clk = p.rt.VirtualClock()
    t = p.rt.RemoteTransport(remote_apply,
                             quiet_tconf(p, max_concurrent=workers),
                             clock=clk, sleep=clk.sleep)
    sched = p.rt.ChaosSchedule(
        [p.rt.ChaosEpisode("brownout", 0.0, 1e9, rate=0.5, name="b")],
        seed=9)
    sched.wrap_transport(t, "remote")
    engine = p.engine.CascadeEngine(p.local, batch_size=8,
                                    remote_fraction_budget=0.5,
                                    t_remote=0.0, transport=t, clock=clk,
                                    **p.kw)
    s = p.serving.MicrobatchScheduler(engine, fallback=lambda r: -7,
                                      pipeline_depth=2,
                                      completion_mode=mode)
    submit_all(p, s, xs)
    resp = s.flush()
    engine.close()
    return {"responses": {r.uid: (int(r.prediction), r.source)
                          for r in resp},
            **billing_digest(p, engine.stats),
            "by_episode": dict(sched.stats.by_episode)}


def test_streaming_and_fifo_bill_identically_under_chaos():
    """The billing identity survives fault injection when windows reach
    the chaos wrapper in submission order: with one transport pool
    worker, two pipelined windows are called in the order the scheduler
    submitted them, in both modes and both packages."""
    rng = np.random.default_rng(8)
    xs, _ = make_stream(rng, 64, hard_frac=1.0)
    fifo = both(chaos_serve, "fifo", xs, workers=1)
    streaming = both(chaos_serve, "streaming", xs, workers=1)
    assert fifo == streaming
    assert fifo["billing"]["transport_failures"] > 0   # chaos fired


def test_concurrent_windows_draw_in_arrival_order():
    """The cause of the JAX test's flake, forced: two windows submitted
    in order to a transport with two pool workers, the first held back
    until the second has drawn. The second window takes the stream's
    first draw, so its fault lands on the other window; with one worker
    the second cannot overtake."""
    def run(p, workers, seed):
        clk = p.rt.VirtualClock()
        t = p.rt.RemoteTransport(remote_apply,
                                 quiet_tconf(p, max_concurrent=workers),
                                 clock=clk, sleep=clk.sleep)
        sched = p.rt.ChaosSchedule(
            [p.rt.ChaosEpisode("brownout", 0.0, 1e9, rate=0.5, name="b")],
            seed=seed)
        chaos = sched.wrap_transport(t, "remote")
        second_drew = threading.Event()

        def gated(batch):
            if workers > 1 and float(np.asarray(batch)[0, 0]) == 0.0:
                second_drew.wait(timeout=30.0)      # hold window 1 back
            try:
                return chaos(batch)
            finally:
                if float(np.asarray(batch)[0, 0]) == 1.0:
                    second_drew.set()

        t.remote_apply = gated
        futs = [t.submit(np.full((1, 2), w, np.float32)) for w in (0, 1)]
        ok = [bool(f.result()[1].all()) for f in futs]
        t.shutdown()
        return ok

    def first_draws(seed):
        ep = trt.ChaosEpisode("brownout", 0.0, 1e9, rate=0.5, name="b")
        rng = random.Random(trt.ChaosSchedule([ep], seed=seed)
                            .stream_seed(ep, "remote"))
        return [rng.random() < 0.5 for _ in range(2)]

    # a seed whose first two draws differ, so a swap shows
    seed = next(s for s in range(64) if len(set(first_draws(s))) == 2)
    draws = first_draws(seed)
    for p in BOTH:
        # one worker: window w fails iff draw w fails
        assert run(p, 1, seed) == [not d for d in draws]
        # two workers, window 1 held back: the draws swap windows
        assert run(p, 2, seed) == [not d for d in draws[::-1]]


# ------------------------------------------------------- bench smoke

def test_loadgen_trace_serves_alike_under_chaos():
    """A ``benchmarks.loadgen`` trace (the bench's request source) served
    through both packages' full runtime stack under a two-backend chaos
    schedule on a virtual clock: every response and billing field, the
    chaos counts and the event counts are equal."""
    from benchmarks.loadgen import generate_trace, make_features, segments

    trace = generate_trace(11, pattern="pareto_burst", rate=50.0,
                           duration_s=4.0)
    xs, _ = make_features(trace)

    def run(p):
        clk = p.rt.VirtualClock()
        tconf = p.rt.TransportConfig(max_in_flight=8, max_retries=1,
                                     retry_backoff_s=0.01, timeout_s=10.0,
                                     breaker_failures=2,
                                     breaker_reset_s=0.5)
        router = p.rt.RemoteRouter(
            [p.rt.RemoteBackend(n, remote_apply, tconf, cost_per_request=c,
                                latency_s=0.05, clock=clk, sleep=clk.sleep)
             for n, c in (("primary", 0.002), ("secondary", 0.008))],
            policy="cheapest-available")
        chaos = p.rt.ChaosSchedule([
            p.rt.ChaosEpisode("brownout", 1.0, 1.0, backends=("primary",),
                              rate=0.7, name="brown"),
            p.rt.ChaosEpisode("outage", 2.5, 0.5, name="blackout")],
            seed=7)
        chaos.wrap_router(router)
        cfg = p.serving.ServeConfig(
            batch_size=8, remote_fraction_budget=0.3, t_remote=0.0,
            pipeline_depth=1, admission_limit=24, observability=True)
        eng, sched = cfg.build(p.local, transport=router,
                               fallback=lambda r: -1, clock=clk, **p.kw)
        resp = []
        for t_end, bucket in segments(trace, 0.5):
            for tr in bucket:
                clk.advance_to(tr.t_arrival_s)
                # a shed response returned here is delivered again by
                # flush, which alone covers every uid
                sched.submit(p.serving.Request(
                    uid=tr.uid, local_input=xs[tr.uid],
                    remote_input=xs[tr.uid]))
            clk.advance_to(t_end)
            resp.extend(sched.flush())
        chaos.finalize(eng.observability.events, now=clk())
        eng.close()
        assert sorted(r.uid for r in resp) == list(range(len(trace)))
        return {"responses": responses_digest(resp),
                **billing_digest(p, eng.stats),
                "chaos": vars(chaos.stats),
                "events": eng.observability.events.counts()}

    out = both(run)
    assert out["chaos"]["injected"] > 0
    assert out["billing"]["transport_failures"] > 0


@dataclasses.dataclass(frozen=True)
class CpuServeConfig(tserving.ServeConfig):
    """The port's ``ServeConfig`` with its engine built on the CPU."""

    def build(self, *args, **kw):
        return super().build(*args, device="cpu", **kw)


class CpuCascadeEngine(tengine.CascadeEngine):
    """The port's ``CascadeEngine`` on the CPU unless told otherwise."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def port_request(**kw):
    """The port's ``Request``; a JAX ``RequestPolicy`` (from
    ``benchmarks.loadgen``) is carried over field by field."""
    pol = kw.get("policy")
    if pol is not None:
        kw["policy"] = tserving.RequestPolicy(**dataclasses.asdict(pol))
    return tserving.Request(**kw)


class TorchJnp:
    """The ``jnp`` names the benches use, on CPU tensors."""
    sin = staticmethod(torch.sin)

    @staticmethod
    def asarray(a):
        return a if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a))

    @staticmethod
    def take(a, idx, axis=0):
        return a.index_select(axis, torch.as_tensor(idx).long())


def port_swap(monkeypatch, bench) -> None:
    """Point a bench module at the port: every class and function it
    imported from ``repro.*`` becomes the port's namesake (the engine,
    ``ServeConfig`` and cluster harness on the CPU), ``jnp`` becomes
    ``TorchJnp``, and requests carry the port's ``RequestPolicy``. The
    bench then drives the port with its own scenario and checks. Its
    constants (billing fields, dispositions, breaker states, event
    names) are the same strings in both packages."""
    special = {"CascadeEngine": CpuCascadeEngine,
               "ServeConfig": CpuServeConfig, "Request": port_request,
               "ClusterHarness": functools.partial(trt.ClusterHarness,
                                                   device="cpu")}
    for name, value in list(vars(bench).items()):
        mod = getattr(value, "__module__", None) or ""
        if name in special:
            monkeypatch.setattr(bench, name, special[name])
        elif mod.startswith("repro.") and callable(value):
            port = importlib.import_module("repro_torch" + mod[len("repro"):])
            monkeypatch.setattr(bench, name, getattr(port, value.__name__))
    monkeypatch.setattr(bench, "jnp", TorchJnp)


def test_chaos_bench_scenario_runs_alike(monkeypatch):
    """The chaos bench's own 60 s scenario (``benchmarks.chaos_bench``,
    five episodes on a virtual clock) driven through the port's runtime:
    every hard check of the bench passes (replay, causal event order,
    zero silent drops, billing reconciliation, recovery), and the digest
    its replay check compares equals the JAX run's."""
    from benchmarks import chaos_bench as bench
    from benchmarks.loadgen import generate_trace, make_features

    trace = generate_trace(7, pattern="diurnal", rate=bench.BASE_RATE,
                           peak_rate=bench.PEAK_RATE, duration_s=60.0,
                           hard_frac=0.25)
    xs, _ = make_features(trace, bench.NCLS)
    want = bench._digest(bench.drive(trace, xs, 7))
    with monkeypatch.context() as m:
        port_swap(m, bench)
        assert bench.ChaosSchedule is trt.ChaosSchedule
        got = bench._digest(bench.drive(trace, xs, 7))
        report = bench.run(verbose=False, duration_s=60.0, seed=7,
                           json_path=None, events_jsonl=None)
    assert report["passed"], report["checks"]
    assert report["admission"]["shed"] > 0
    assert report["chaos"]["injected"] > 0
    assert got == want
