"""The measured window: the general loops that a mix's ``loop`` names.

* ``backlog``: requests are kept queued ahead of ``flush`` in blocks of
  ``block``, so the cascade is never starved; the window closes at the
  first flush boundary after ``seconds``.
* ``poisson``: an open loop. The main thread submits each request at its
  due time (``traffic/loadgen.py``), with that due time as its enqueue
  time; a server thread flushes whatever is queued until the last
  request has come and the queue is drained. A request's latency is its
  hand-back, stamped on the harness's clock (``HandBack``), less its due
  time. A trace opens between arrivals and closes after the drain.
* ``qa``: a closed loop of generate calls, each on new prompts, until
  ``seconds`` have passed at a call boundary.

Each returns a ``Window``: what the metrics and the check read. Nothing
is built or compiled here: ``stack.*.warm_up`` ran every shape first.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from cascade_bench.stack import ARRIVALS, now, stream, sync
from cascade_bench.traffic import loadgen


@dataclass
class Window:
    elapsed_s: float
    attempted: int
    responses: list = field(default_factory=list)
    lags_s: list = field(default_factory=list)       # submit - due
    latencies_s: list = field(default_factory=list)  # hand-back - due
    remote_rows: list = field(default_factory=list)  # rows per prefill
    transport_s: list = field(default_factory=list)  # per remote window
    billing: dict = field(default_factory=dict)      # engine's, over it
    calls: int = 0                                    # generate calls
    overhead_s: float = 0.0                           # profiler open/close


class HandBack(dict):
    """The scheduler's record of what it has handed back
    (``MicrobatchScheduler.responses``, uid -> ``Response``, written at
    hand-back), which stamps each uid on the harness's clock as it is
    written: the open loop's latency is this stamp less the due time."""

    def __init__(self, *args):
        super().__init__(*args)
        self.at: dict = {}

    def __setitem__(self, uid, resp):
        self.at.setdefault(uid, now())
        super().__setitem__(uid, resp)


def _billing(engine) -> dict:
    from repro_torch.serving.engine import BILLING_FIELDS
    return {f: getattr(engine.stats, f) for f in BILLING_FIELDS}


def _transport_samples(stack) -> list:
    return [s for b in stack.router for s in b.stats.latency_samples]


def _classify_begin(stack):
    stack.recording = True
    return _billing(stack.engine), len(_transport_samples(stack))


def _classify_end(stack, win: Window, before, n_lat) -> Window:
    stack.recording = False
    after = _billing(stack.engine)
    win.billing = {k: after[k] - before[k] for k in after}
    win.remote_rows = list(stack.remote_rows)
    win.transport_s = _transport_samples(stack)[n_lat:]
    return win


def backlog(stack, seconds: float, tracer) -> Window:
    block = stack.mix["block"]
    sched = stack.scheduler
    before, n_lat = _classify_begin(stack)
    responses: list = []
    uid = 0
    t0 = now()
    while True:
        elapsed = now() - t0
        tracer.boundary(elapsed, {"remote_calls": len(stack.remote_rows)})
        if elapsed >= seconds:
            break
        for i in range(uid, uid + block):
            sched.submit(stack.request(i))
        uid += block
        responses.extend(sched.flush())
    sync(stack.device)
    win = Window(elapsed_s=now() - t0, attempted=uid, responses=responses)
    tracer.finish({"remote_calls": len(stack.remote_rows)})
    win.overhead_s = tracer.overhead_s
    return _classify_end(stack, win, before, n_lat)


def poisson(stack, seconds: float, tracer) -> Window:
    mix = stack.mix
    sched = stack.scheduler
    due = loadgen.due_times(stream(stack.seed, ARRIVALS), mix["rate"],
                            seconds)
    reqs = [stack.request(i) for i in range(due.size)]
    handback = HandBack(sched.responses)
    sched.responses = handback
    lags = np.zeros(due.size)
    arrived, done = threading.Event(), threading.Event()
    failure: list = []
    responses: list = []

    def marks():
        return {"remote_calls": len(stack.remote_rows)}

    def serve():
        # one streaming flush drains whatever has arrived, and keeps
        # taking what arrives meanwhile
        try:
            while not done.is_set() or sched.queue:
                if sched.queue:
                    responses.extend(sched.flush())
                else:
                    arrived.wait(0.002)
                    arrived.clear()
        except BaseException as e:       # surfaced by the generator
            failure.append(e)
            raise

    before, n_lat = _classify_begin(stack)
    server = threading.Thread(target=serve, name="bench-server")
    t0 = now()
    stamps = t0 + due
    server.start()
    try:
        for i, req in enumerate(reqs):
            wait = stamps[i] - now()
            if wait > 0:
                time.sleep(wait)
            req.t_enq = stamps[i]
            lags[i] = now() - stamps[i]
            sched.submit(req)
            arrived.set()
            tracer.boundary(now() - t0, marks())
    finally:
        done.set()
        arrived.set()
        server.join()
    if failure:
        raise failure[0]
    sync(stack.device)
    win = Window(elapsed_s=now() - t0, attempted=int(due.size),
                 responses=responses, lags_s=lags.tolist())
    # the trace closes once the last request is served: reading it holds
    # the interpreter, which would stall windows still in flight
    tracer.finish(marks())
    win.latencies_s = [handback.at[i] - stamps[i] if i in handback.at
                       else np.inf for i in range(due.size)]
    win.overhead_s = tracer.overhead_s
    return _classify_end(stack, win, before, n_lat)


def qa(stack, seconds: float, tracer) -> Window:
    calls = []
    t0 = now()
    while True:
        elapsed = now() - t0
        tracer.boundary(elapsed, {"calls": len(calls)})
        if elapsed >= seconds:
            break
        c = len(calls) + 1          # call 0 warmed up
        toks, liks, minlik, _ = stack.call(c)
        calls.append((c, toks, liks, minlik))
    win = Window(elapsed_s=now() - t0, attempted=len(calls) * stack.batch,
                 calls=len(calls))
    tracer.finish({"calls": len(calls)})
    win.overhead_s = tracer.overhead_s
    stack.calls = calls
    return win


LOOPS = {"backlog": backlog, "poisson": poisson, "qa": qa}
