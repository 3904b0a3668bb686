"""The port's spans on the profiler's timeline (``runtime.observability
.span``, listed in that module's docstring), on the CPU with the
transport's pool threads.

Under ``torch.profiler`` every main-thread span of a depth-1 FIFO window
is in the trace once, nested as the window runs; ``SPANS`` counts the
spans of every thread, the pool threads' too, which the trace does not
hold. With no profiler recording, ``span`` enters nothing and ``SPANS``
stays as it was. What is served is the same either way.
"""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.runtime import RemoteTransport, TransportConfig  # noqa: E402
from repro_torch.runtime import observability as obs  # noqa: E402
from repro_torch.serving import (CascadeEngine, MicrobatchScheduler,  # noqa: E402
                                 Request)
from repro_torch.serving.engine import BILLING_FIELDS  # noqa: E402

N_REQ, BATCH, WINDOW_ROWS = 32, 8, 2
WINDOWS = N_REQ // BATCH
# budget 0.5 escalates 4 rows a window, sent in transport windows of 2
TRANSPORT_WINDOWS = WINDOWS * 2
# the main thread's spans of one synchronous window, outermost first
MAIN = ("cascade.window", "cascade.dispatch", "cascade.gate_wait",
        "cascade.host_half", "cascade.remote_wait", "transport.window",
        "cascade.finalize", "cascade.commit")


def _counts(name: str = "span_seconds") -> dict:
    """Each span's count in ``SPANS`` under ``name``."""
    out = {}
    for key, h in obs.SPANS.snapshot()["histograms"].items():
        metric, _, label = key.partition("{")
        if metric == name:
            out[label.split('"')[1]] = h["count"]
    return out


def _sums() -> dict:
    """Each span's host seconds in ``SPANS``."""
    return {k.split('"')[1]: h["sum"]
            for k, h in obs.SPANS.snapshot()["histograms"].items()
            if k.startswith("span_seconds{")}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _rows():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 4, N_REQ)
    x = rng.normal(0, 0.05, (N_REQ, 4))
    x[np.arange(N_REQ), labels] += np.where(rng.random(N_REQ) < 0.5, 0.1,
                                            3.0)
    return np.float32(x)


def _serve(depth: int = 1):
    """A cascade over ``_rows``: (responses by uid, billing)."""
    transport = RemoteTransport(
        lambda x: 5.0 * torch.as_tensor(np.asarray(x)),
        TransportConfig(max_in_flight=WINDOW_ROWS, retry_backoff_s=0.0,
                        max_retries=0, breaker_failures=10**6,
                        timeout_s=60.0))
    engine = CascadeEngine(lambda x: x + 0.3 * torch.sin(17.0 * x),
                           batch_size=BATCH, remote_fraction_budget=0.5,
                           t_remote=0.0, transport=transport, device="cpu")
    sched = MicrobatchScheduler(engine, fallback=lambda r: -7,
                                pipeline_depth=depth)
    try:
        for i, row in enumerate(_rows()):
            sched.submit(Request(uid=i, local_input=row, remote_input=row))
        responses = sched.flush()
    finally:
        engine.close()
    rows = {r.uid: (r.prediction, r.source, r.disposition, r.cost,
                    r.local_conf, r.remote_conf) for r in responses}
    return rows, {f: getattr(engine.stats, f) for f in BILLING_FIELDS}


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in MAIN
                 or e.name.startswith(("transport.", "generate."))]


def test_fifo_window_spans_nest_in_the_trace_and_count_every_thread():
    before, before_s = _counts(), _sums()
    (rows, billing), events = _traced(_serve)
    assert len(rows) == N_REQ and billing["remote_calls"] == WINDOWS * 4
    by_name = {n: sorted((e for e in events if e.name == n),
                         key=lambda e: e.time_range.start) for n in MAIN}
    # the main thread's spans: once a window (two transport windows)
    for n in MAIN:
        want = TRANSPORT_WINDOWS if n == "transport.window" else WINDOWS
        assert len(by_name[n]) == want, n
    # the attempt runs on the ``remote-attempt`` pool: not in the trace
    assert not [e for e in events if e.name == "transport.attempt"]

    def inside(inner, outer):
        return (outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    for w in range(WINDOWS):
        win = by_name["cascade.window"][w]
        parts = [by_name[n][w] for n in
                 ("cascade.dispatch", "cascade.gate_wait",
                  "cascade.host_half", "cascade.finalize", "cascade.commit")]
        assert all(inside(p, win) for p in parts)
        for a, b in zip(parts, parts[1:]):        # one after another
            assert a.time_range.end <= b.time_range.start
        wait = by_name["cascade.remote_wait"][w]
        assert inside(wait, by_name["cascade.host_half"][w])
        for t in by_name["transport.window"][2 * w:2 * w + 2]:
            assert inside(t, wait)
    got = _delta(before, _counts())
    assert got["cascade.window"] == WINDOWS
    assert got["transport.window"] == got["transport.attempt"] \
        == TRANSPORT_WINDOWS
    assert got == {n: len(by_name[n]) for n in MAIN} | {
        "transport.attempt": TRANSPORT_WINDOWS}
    # a span's host seconds lie inside its stretch of the trace
    host = _sums()["cascade.window"] - before_s.get("cascade.window", 0.0)
    trace = sum(e.time_range.end - e.time_range.start
                for e in by_name["cascade.window"]) * 1e-6
    assert 0.5 * trace <= host <= 1.01 * trace + 1e-5


def test_pipelined_transport_window_runs_on_the_pool_thread():
    """At depth 2 each transport window runs on the ``remote-transport``
    pool: ``SPANS`` counts it, the trace does not hold it, and the
    engine's wait on the future is the ``cascade.remote_wait`` span."""
    before = _counts()
    (rows, _), events = _traced(lambda: _serve(depth=2))
    assert len(rows) == N_REQ
    names = [e.name for e in events]
    assert "transport.window" not in names
    assert "transport.attempt" not in names
    assert names.count("cascade.remote_wait") == WINDOWS
    got = _delta(before, _counts())
    assert got["transport.window"] == got["transport.attempt"] \
        == TRANSPORT_WINDOWS
    assert got["cascade.remote_wait"] == WINDOWS


def test_no_profiler_enters_nothing_and_counts_nothing(monkeypatch):
    entered = []
    real = obs._profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(obs._profiler, "record_function", counting)
    before = obs.SPANS.snapshot()
    rows, _ = _serve()
    assert len(rows) == N_REQ
    assert entered == []
    assert obs.SPANS.snapshot() == before
    # one shared no-op, whatever the name: nothing allocated, no clock
    monkeypatch.setattr(obs, "time", SimpleNamespace(
        perf_counter=lambda: pytest.fail("span read a clock")))
    off = obs.span("cascade.window")
    assert off is obs.span("transport.attempt", device=True)
    with off:
        pass
    # and under a profiler the same call enters record_function
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.undo()
        monkeypatch.setattr(obs._profiler, "record_function", counting)
        with obs.span("probe.on"):
            pass
    assert entered == ["probe.on"]


def test_outputs_are_bitwise_the_same_under_a_profiler():
    plain = _serve()
    (traced, _) = _traced(_serve)
    assert traced == plain
    plain2 = _serve(depth=2)
    (traced2, _) = _traced(lambda: _serve(depth=2))
    assert traced2 == plain2


def test_a_span_records_through_an_exception_and_on_the_cpu_no_device():
    before = _counts()
    before_dev = _counts("span_device_seconds")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with obs.span("probe.raises", device=True):
                raise ValueError("boom")
    assert _delta(before, _counts()) == {"probe.raises": 1}
    # no CUDA on this thread: no event pair to time
    assert _counts("span_device_seconds") == before_dev
    assert 'span_seconds_count{span="probe.raises"}' in \
        obs.SPANS.render_prometheus()


def _tiny_generate():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("yi-6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(1, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": prompt}


@pytest.mark.parametrize("new_tokens", [1, 4])
def test_generate_counts_a_step_span_per_decode_step(new_tokens):
    from repro_torch.serving.generate import greedy_generate
    cfg, params, prompt = _tiny_generate()
    plain = greedy_generate(cfg, params, prompt, new_tokens)
    before = _counts()
    traced, events = _traced(
        lambda: greedy_generate(cfg, params, prompt, new_tokens))
    got = _delta(before, _counts())
    want = {"generate.prefill": 1, "generate.graft": 1}
    if new_tokens > 1:
        want["generate.step"] = new_tokens - 1
    assert got == want
    assert sorted(e.name for e in events) == sorted(
        n for n, c in want.items() for _ in range(c))
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


@pytest.mark.parametrize("new_tokens", [1, 4])
def test_generate_counts_its_decode_steps_by_path(new_tokens):
    """``generate_decode_steps_total`` rises by a call's decode steps
    under its path, profiler or not: the eager loop on the CPU."""
    from repro_torch.serving.generate import greedy_generate
    cfg, params, prompt = _tiny_generate()
    steps = {p: obs.SPANS.counter("generate_decode_steps_total", path=p)
             for p in ("graph", "eager")}
    before = {p: c.value for p, c in steps.items()}
    greedy_generate(cfg, params, prompt, new_tokens)
    _traced(lambda: greedy_generate(cfg, params, prompt, new_tokens))
    assert {p: c.value - before[p] for p, c in steps.items()} == {
        "graph": 0, "eager": 2 * (new_tokens - 1)}
    assert 'generate_decode_steps_total{path="eager"}' in \
        obs.SPANS.render_prometheus()


def test_spans_from_many_threads_lose_no_count():
    """``SPANS`` is written from every thread a span runs on: with more
    threads than cores and a short switch interval no count is lost."""
    import sys
    import threading

    def work():
        for _ in range(200):
            with obs.span("probe.threads"):
                pass

    before = _counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _delta(before, _counts()) == {"probe.threads": 16 * 200}


class _FakeEvent:
    """A CUDA timing event on a made-up stream: ``record`` stamps the
    next millisecond, and the stream passes it when the test says so."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        type(self).made += 1
        self.t, self.passed = None, False

    def record(self):
        type(self).clock += 1.0
        self.t, self.passed = type(self).clock, False

    def query(self):
        return self.passed

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_pairs_resolve_without_waiting_and_reuse_their_events(
        monkeypatch):
    """``device=True`` pairs are observed once the stream has passed
    their end, at a span's exit or a read of ``SPANS``, never waited on;
    resolved events go back to the pool and the next spans reuse them."""
    monkeypatch.setattr(obs.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(obs.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(obs, "_PAIRS", deque())
    monkeypatch.setattr(obs, "_EVENTS", [])
    _FakeEvent.made = 0

    def dev():
        snap = obs.SPANS.snapshot()["histograms"]
        h = snap.get('span_device_seconds{span="probe.dev"}')
        return (0, 0.0) if h is None else (h["count"], h["sum"])

    before = dev()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with obs.span("probe.dev", device=True):
                pass
    assert _FakeEvent.made == 6 and len(obs._PAIRS) == 3
    assert dev() == before                  # nothing passed: nothing read
    for _, _, end in list(obs._PAIRS)[:2]:
        end.passed = True
    n, s = dev()                            # the read resolves two
    assert n - before[0] == 2
    assert s - before[1] == pytest.approx(2e-3)   # 1 ms a pair
    assert len(obs._PAIRS) == 1 and len(obs._EVENTS) == 4
    obs._PAIRS[0][2].passed = True
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("probe.dev", device=True):
            pass                            # its exit resolves the third
    assert _FakeEvent.made == 6             # two pooled events reused
    assert dev()[0] - before[0] == 3 and len(obs._PAIRS) == 1
