"""Early emit and the gate triple's fetch in the port, against the JAX
package (DESIGN.md §11).

On the CPU the gate runs its plain version and the triple is on the host
as soon as the step returns, so an emit fires synchronously, as JAX's
``io_callback`` does inside a CPU jit. What only the card can show (a
pinned buffer read before its event, one buffer reused across windows in
flight, the watcher thread on a real event) is in ``test_torch_cuda.py``.

Tolerances: pred, idx, responses and billing exact; conf within 1e-6
(f32 softmax statistics summed in another order).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.confidence_gate.ops import \
    confidence_gate as jax_confidence_gate  # noqa: E402
from repro.kernels.fused_head_gate.ops import \
    fused_head_gate as jax_fused_head_gate  # noqa: E402
from repro.runtime import RemoteTransport as JaxRemoteTransport  # noqa: E402
from repro.runtime import TransportConfig as JaxTransportConfig  # noqa: E402
from repro.serving.engine import BILLING_FIELDS  # noqa: E402
from repro.serving.engine import CascadeEngine as JaxCascadeEngine  # noqa: E402
from repro.serving.scheduler import \
    MicrobatchScheduler as JaxScheduler  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.kernels.confidence_gate.ops import confidence_gate  # noqa: E402
from repro_torch.kernels.fused_head_gate.ops import fused_head_gate  # noqa: E402
from repro_torch.kernels.gate_fetch import Emitter, start_fetch  # noqa: E402
from repro_torch.runtime import RemoteTransport, TransportConfig  # noqa: E402
from repro_torch.serving import (CascadeEngine, MicrobatchScheduler,  # noqa: E402
                                 Request, ServeConfig)

CONF_TOL = 1e-6
N_REQ, BATCH, DEPTH = 48, 8, 4


# ------------------------------------------------ (a) the ops with emit

def _recorder():
    fired = []

    def emit(tag, conf, pred, idx):
        fired.append((int(tag), np.array(conf), np.array(pred),
                      np.array(idx)))

    return fired, emit


def _gate_inputs(kind: str):
    rng = np.random.default_rng(7)
    if kind == "gate":
        return (rng.normal(0, 4.0, (8, 64)).astype(np.float32),)
    h = rng.normal(0, 1.0, (8, 32)).astype(np.float32)
    w = (rng.normal(0, 1.0, (32, 40)) / np.sqrt(32)).astype(np.float32)
    bias = rng.normal(0, 0.1, (40,)).astype(np.float32)
    return h, w, bias


@pytest.mark.parametrize("kind", ["gate", "fused_head"])
def test_gate_emit_fires_once_with_jax_triple(kind):
    """The port's gate with ``emit`` and tag 11 fires once, on the CPU
    synchronously, with the triple it returns, and that triple is JAX's
    on the same inputs (tests/test_kernels.py's early-emit test across
    the packages)."""
    args = _gate_inputs(kind)
    kw = dict(supervisor="max_softmax", k=4, emit_tag=11)
    jfired, jemit = _recorder()
    tfired, temit = _recorder()
    if kind == "gate":
        jout = jax.jit(lambda x: jax_confidence_gate(
            x, 0.5, emit=jemit, **kw))(jnp.asarray(args[0]))
        tout = confidence_gate(torch.from_numpy(args[0]), 0.5, emit=temit,
                               **kw)
    else:
        jout = jax.jit(lambda h, w, b: jax_fused_head_gate(
            h, w, b, 0.5, emit=jemit, **kw))(*map(jnp.asarray, args))
        tout = fused_head_gate(*map(torch.from_numpy, args), 0.5,
                               emit=temit, **kw)
    jax.block_until_ready(jout["pred"])
    assert len(jfired) == 1 and len(tfired) == 1
    (jtag, jconf, jpred, jidx), (ttag, tconf, tpred, tidx) = \
        jfired[0], tfired[0]
    assert jtag == ttag == 11
    np.testing.assert_array_equal(tpred, jpred)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(tconf, jconf, rtol=0, atol=CONF_TOL)
    # the emitted triple is the returned one
    np.testing.assert_array_equal(tpred, tout["pred"].numpy())
    np.testing.assert_array_equal(tidx, tout["idx"].numpy())
    np.testing.assert_array_equal(tconf, tout["conf"].numpy())
    assert (tidx >= 0).sum() > 0


@pytest.mark.parametrize("kind", ["gate", "fused_head"])
def test_gate_emit_returns_the_fetch_it_hands_the_emitter(kind):
    """With an ``Emitter`` the gate returns, under ``fetch``, the copy it
    handed the emitter: the host waits on that one, no second copy."""
    args = tuple(map(torch.from_numpy, _gate_inputs(kind)))
    fired, emit = _recorder()
    em = Emitter(emit)
    if kind == "gate":
        out = confidence_gate(args[0], 0.5, k=4, emit=em, emit_tag=3)
    else:
        out = fused_head_gate(*args, 0.5, k=4, emit=em, emit_tag=3)
    em.close()
    assert [f[0] for f in fired] == [3]
    for a, b in zip(out["fetch"].wait(), fired[0][1:]):
        np.testing.assert_array_equal(a, b)
    plain = (confidence_gate(args[0], 0.5, k=4) if kind == "gate"
             else fused_head_gate(*args, 0.5, k=4))
    assert "fetch" not in plain
    for k in ("conf", "pred", "idx"):
        np.testing.assert_array_equal(out[k].numpy(), plain[k].numpy())


def test_gated_local_step_with_emit_takes_a_seq():
    """``make_gated_local_step(..., emit=...)``: the step takes a trailing
    ``seq`` and emits once per call with it as the tag (JAX's form)."""
    from repro.serving.engine import \
        make_gated_local_step as jax_make_gated_local_step
    from repro_torch.serving import make_gated_local_step
    x = _gate_inputs("gate")[0]
    jfired, jemit = _recorder()
    tfired, temit = _recorder()
    jstep = jax_make_gated_local_step(lambda v: v, emit=jemit)
    tstep = make_gated_local_step(lambda v: v, emit=temit)
    jout = jstep(jnp.asarray(x), jnp.float32(0.5), jnp.int32(6),
                 jnp.int32(5))
    jax.block_until_ready(jout["idx"])
    tout = tstep(torch.from_numpy(x), 0.5, 6, 5)
    assert [f[0] for f in jfired] == [f[0] for f in tfired] == [5]
    np.testing.assert_array_equal(tfired[0][3], np.asarray(jout["idx"]))
    np.testing.assert_array_equal(tfired[0][2], tout["pred"].numpy())


def test_emit_on_a_cpu_triple_needs_no_emitter():
    """A plain callable is enough on the CPU; ``start_fetch`` of a CPU
    triple is landed at once and gives the same numbers."""
    logits = torch.from_numpy(_gate_inputs("gate")[0])
    out = confidence_gate(logits, 0.5, k=4)
    pending = start_fetch(out)
    assert pending.ready()
    for a, k in zip(pending.wait(), ("conf", "pred", "idx")):
        np.testing.assert_array_equal(a, out[k].numpy())


# ---------------------------------------------------- the Emitter thread

class _Held:
    """A pending triple that lands when the test says so (the CPU has no
    event that completes later)."""

    def __init__(self, tag):
        self.landed = threading.Event()
        self.tag = tag

    def ready(self):
        return self.landed.is_set()

    def wait(self):
        assert self.landed.wait(10.0), "never landed"
        return (np.full(2, self.tag, np.float32),
                np.full(2, self.tag, np.int32), np.arange(2, dtype=np.int32))


def test_emitter_emits_in_submission_order_and_close_joins():
    got = []
    em = Emitter(lambda tag, conf, pred, idx: got.append(
        (tag, int(pred[0]))))
    held = [_Held(t) for t in range(6)]
    for h in held:
        em.submit(h.tag, h)
    assert em.alive
    for h in reversed(held):            # landing order does not matter
        h.landed.set()
    em.wait()
    assert got == [(t, t) for t in range(6)]
    em.close()
    assert not em.alive                 # the watcher is joined
    em.submit(6, held[0])               # landed: emitted on the caller
    assert got[-1] == (6, 0) and not em.alive


def test_emitter_keeps_an_error_and_raises_it_once():
    def boom(tag, conf, pred, idx):
        raise ValueError(f"emit failed for {tag}")

    em = Emitter(boom)
    h = _Held(3)
    em.submit(3, h)
    h.landed.set()
    with pytest.raises(ValueError, match="emit failed for 3"):
        em.wait()
    em.close()                          # raised once, not again
    assert not em.alive
    em2 = Emitter(boom)
    h2 = _Held(4)
    em2.submit(4, h2)
    h2.landed.set()
    with pytest.raises(ValueError, match="emit failed for 4"):
        em2.close()
    assert not em2.alive


def test_emitter_keeps_order_under_racing_landings():
    """Stress: 200 triples land from 8 threads in random order while the
    interpreter switches threads every microsecond; every triple is
    emitted once, in submission order."""
    import random
    import sys
    got = []
    em = Emitter(lambda tag, conf, pred, idx: got.append(tag))
    held = [_Held(t) for t in range(200)]
    order = list(held)
    random.Random(0).shuffle(order)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for h in held:
            em.submit(h.tag, h)
        workers = [threading.Thread(target=lambda part: [
            h.landed.set() for h in part], args=(order[i::8],))
            for i in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(10.0)
        assert not any(w.is_alive() for w in workers)
        em.close()
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(200))
    assert not em.alive


# ------------------------------------- (b) the engines across packages

def _stream():
    """tests/test_continuous.py's stream: easy rows and hard ones."""
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 4, N_REQ)
    x = rng.normal(0, 0.05, (N_REQ, 4))
    margin = np.where(rng.random(N_REQ) < 0.5, 0.1, 3.0)
    x[np.arange(N_REQ), labels] += margin
    return np.float32(x)


def _quiet(cls):
    return cls(retry_backoff_s=0.0, max_retries=0, breaker_failures=10**6,
               timeout_s=60.0)


def _serve(pkg: str, early_emit, batching="continuous"):
    xs = _stream()
    if pkg == "jax":
        transport = JaxRemoteTransport(lambda x: 5.0 * np.asarray(x),
                                       _quiet(JaxTransportConfig))
        engine = JaxCascadeEngine(
            lambda x: x + 0.3 * jnp.sin(17.0 * x), batch_size=BATCH,
            remote_fraction_budget=0.5, t_remote=0.0, transport=transport,
            early_emit=early_emit)
        sched_cls, req = JaxScheduler, JaxRequest
    else:
        transport = RemoteTransport(lambda x: 5.0 * np.asarray(x),
                                    _quiet(TransportConfig))
        engine = CascadeEngine(
            lambda x: x + 0.3 * torch.sin(17.0 * x), batch_size=BATCH,
            remote_fraction_budget=0.5, t_remote=0.0, transport=transport,
            early_emit=early_emit, device="cpu")
        sched_cls, req = MicrobatchScheduler, Request
    sched = sched_cls(engine, fallback=lambda r: -7, pipeline_depth=DEPTH,
                      completion_mode="streaming", batching=batching)
    try:
        for i, row in enumerate(xs):
            sched.submit(req(uid=i, local_input=row, remote_input=row))
        responses = sched.flush()
        emits, left = engine._gate_emits, dict(engine._gate_results)
    finally:
        engine.close()
    rows = {r.uid: (r.prediction, r.source, r.disposition, r.cost)
            for r in responses}
    billing = {f: getattr(engine.stats, f) for f in BILLING_FIELDS}
    return rows, billing, engine, emits, left


def test_early_emit_engines_match_jax_and_sweep():
    """Both packages' engines with ``early_emit=True``, continuous
    batching and streaming completion, serve the same stream: the same
    response for every uid, the same billing, one emit per dispatch and
    every stored triple swept at commit (tests/test_continuous.py's
    forced early-emit test across the packages)."""
    j_rows, j_bill, j_eng, j_emits, j_left = _serve("jax", True)
    t_rows, t_bill, t_eng, t_emits, t_left = _serve("torch", True)
    assert j_eng.early_emit and t_eng.early_emit
    assert len(t_rows) == N_REQ
    assert t_rows == j_rows
    assert t_bill == j_bill
    assert j_emits == t_emits == N_REQ // BATCH
    assert j_left == t_left == {}
    assert t_eng._gate_results == {}
    assert {r[1] for r in t_rows.values()} >= {"local", "remote"}


@pytest.mark.parametrize("batching", ["continuous", "window"])
def test_port_early_emit_on_matches_off(batching):
    on_rows, on_bill, on_eng, on_emits, _ = _serve("torch", True, batching)
    off_rows, off_bill, off_eng, off_emits, _ = _serve("torch", False,
                                                       batching)
    assert on_eng.early_emit and not off_eng.early_emit
    assert on_rows == off_rows and on_bill == off_bill
    assert (on_emits, off_emits) == (N_REQ // BATCH, 0)
    assert on_eng._emitter is not None and not on_eng._emitter.alive


@pytest.mark.parametrize("early_emit", [True, False])
def test_engine_fetches_each_window_once(early_emit, monkeypatch):
    """One copy of the triple per dispatched window: with early emit the
    gate's fetch (the emitter's) is the one the host half waits on."""
    from repro_torch.kernels import gate_fetch
    from repro_torch.serving import engine as port_engine
    calls = []

    def counted(real):
        def start_fetch(out):
            calls.append(1)
            return real(out)
        return start_fetch

    monkeypatch.setattr(gate_fetch, "start_fetch",
                        counted(gate_fetch.start_fetch))
    monkeypatch.setattr(port_engine, "start_fetch",
                        counted(port_engine.start_fetch))
    rows, _, eng, emits, _ = _serve("torch", early_emit)
    assert len(rows) == N_REQ
    assert len(calls) == eng._seq == N_REQ // BATCH
    assert emits == (eng._seq if early_emit else 0)


# ------------------------------------------------------ (c) "auto" on CPU

def test_auto_resolves_to_off_on_the_cpu():
    transport = RemoteTransport(lambda x: x, _quiet(TransportConfig))
    eng = CascadeEngine(lambda x: x, batch_size=4,
                        remote_fraction_budget=0.5, t_remote=0.5,
                        transport=transport, early_emit="auto",
                        device="cpu")
    assert eng.early_emit is False and eng._emitter is None
    eng.close()
    cfg = ServeConfig(batch_size=4, remote_fraction_budget=0.5,
                      pipeline_depth=2, completion_mode="streaming",
                      batching="continuous")
    eng, _ = cfg.build(lambda x: x, lambda x: x, device="cpu")
    assert eng.early_emit is False
    eng.close()


def test_early_emit_needs_the_runtime_path():
    eng = CascadeEngine(lambda x: x, lambda x: x, batch_size=4,
                        remote_fraction_budget=0.5, t_remote=0.5,
                        early_emit=True, device="cpu")
    assert eng.early_emit is False


# ------------------------------- (d) an emit error is never swallowed

class _BoomEngine(CascadeEngine):
    def _on_gate(self, seq, conf, pred, idx):
        raise RuntimeError(f"emit boom at window {seq}")


def _boom_engine():
    transport = RemoteTransport(lambda x: 5.0 * np.asarray(x),
                                _quiet(TransportConfig))
    return _BoomEngine(lambda x: x + 0.3 * torch.sin(17.0 * x),
                       batch_size=BATCH, remote_fraction_budget=0.5,
                       t_remote=0.0, transport=transport, early_emit=True,
                       device="cpu")


def test_emit_error_comes_out_at_the_next_engine_call():
    xs = _stream()
    batch = {"local": xs[:BATCH], "remote": xs[:BATCH]}
    eng = _boom_engine()
    out = eng.serve(batch)              # the host half waited itself
    assert out["prediction"].shape == (BATCH,)
    with pytest.raises(RuntimeError, match="emit boom at window 1"):
        eng.serve(batch)
    eng.close()                         # raised once, already


def test_emit_error_comes_out_at_close():
    xs = _stream()
    eng = _boom_engine()
    eng.serve({"local": xs[:BATCH], "remote": xs[:BATCH]})
    with pytest.raises(RuntimeError, match="emit boom at window 1"):
        eng.close()
    assert eng.router is not None       # and the pools are shut down
    assert eng._emitter is not None and not eng._emitter.alive


class _DrainBoomEngine(_BoomEngine):
    def complete_next(self):
        raise RuntimeError("drain boom")


def test_close_joins_the_watcher_when_the_drain_fails():
    """A drain that raises in ``close()`` still joins the watcher and shuts
    the pools down; the drain's exception is the one raised, with what the
    watcher kept as a note."""
    xs = _stream()
    transport = RemoteTransport(lambda x: 5.0 * np.asarray(x),
                                _quiet(TransportConfig))
    eng = _DrainBoomEngine(lambda x: x + 0.3 * torch.sin(17.0 * x),
                           batch_size=BATCH, remote_fraction_budget=0.5,
                           t_remote=0.0, transport=transport,
                           early_emit=True, device="cpu")
    shut = []
    real_shutdown = eng.router.shutdown
    eng.router.shutdown = lambda wait=True: (shut.append(wait),
                                             real_shutdown(wait=wait))
    eng.begin_serve({"local": xs[:BATCH], "remote": xs[:BATCH]})
    assert eng.inflight
    with pytest.raises(RuntimeError, match="drain boom") as info:
        eng.close()
    assert any("emit boom at window 1" in n
               for n in getattr(info.value, "__notes__", []))
    assert not eng._emitter.alive
    assert shut == [True]
