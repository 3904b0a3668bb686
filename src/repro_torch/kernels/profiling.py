"""Device kernels of a call, captured with torch.profiler.

``kernel_events(fn, calls)`` runs ``calls`` back-to-back calls of ``fn``
under torch.profiler (CUDA activity) and returns the trace's device
kernel events (``key_averages()`` rows on the CUDA device with at least
one launch). The card's work is drained before the session opens and
inside it before it closes, so no kernel of an earlier call spills into
the trace and none of these calls is cut off. A trace with no kernel
event at all is taken again after a pause of ``RETRY_PAUSE_S``, up to
``ATTEMPTS`` captures; then ``EmptyTraceError`` is raised, so a device
time is never silently missing. A trace that holds kernel events is kept as it is, whatever
kernels it names: the caller decides what a missing kernel means.

``CAPTURES`` counts, per number of attempts a capture took, how many
captures there were in this process (``{1: n1, 2: n2, ...}``).

Run as a module on a CUDA machine, it measures how often a session comes
back empty, and how many empty sessions come in a row, under the
conditions that could cause it (see ``probe``)::

    PYTHONPATH=src python -m repro_torch.kernels.profiling --sessions 1000
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from collections import Counter
from collections.abc import Callable

import torch

__all__ = ["ATTEMPTS", "CAPTURES", "EmptyTraceError", "device_us",
           "kernel_events"]

# Empty sessions come in runs, as if the tracer lost a window of ~0.1 s
# now and then (the probe on an H100: 0.1-0.4 empty a second of tracing,
# up to 3 in a row back to back). After a 0.25 s pause, 13 of 14 retries
# held kernels at the 2nd attempt and one at the 3rd (15000 captures);
# with no pause 11 of 13 needed a 3rd or a 4th. Five attempts leave two
# beyond the longest run seen.
ATTEMPTS = 5
RETRY_PAUSE_S = 0.25
CAPTURES: Counter = Counter()
_LOCK = threading.Lock()


class EmptyTraceError(RuntimeError):
    """torch.profiler recorded no device kernel in any attempt."""


def device_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v:
            return float(v)
    return 0.0


def _kernels(prof) -> list:
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.count]


def _session(fn: Callable[[], object], calls: int, activities) -> list:
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _kernels(prof)


def _capture(fn: Callable[[], object], calls: int, activities,
             attempts: int, pause: float) -> tuple[list, int]:
    """(kernel events, attempts taken): sessions until one holds a kernel
    event, ``pause`` seconds before each one after the first; no events
    if all ``attempts`` were empty."""
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            time.sleep(pause)
        kern = _session(fn, calls, activities)
        if kern:
            return kern, attempt
    return [], attempts


def kernel_events(fn: Callable[[], object], calls: int = 20,
                  cpu: bool = False) -> list:
    """The device kernel events of ``calls`` calls of ``fn`` (see the
    module's docstring), with CPU activity traced too if ``cpu``; raises
    ``EmptyTraceError`` after ``ATTEMPTS`` empty captures."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    kern, attempt = _capture(fn, calls, acts, ATTEMPTS, RETRY_PAUSE_S)
    if kern:
        with _LOCK:
            CAPTURES[attempt] += 1
        return kern
    raise EmptyTraceError(
        f"torch.profiler recorded no device kernel in {ATTEMPTS} captures "
        f"of {calls} calls")


def probe(sessions: int, calls: int = 10, only=None):
    """Yields, per condition, over ``sessions`` sessions one after
    another: how many came back empty, how many runs of 1, 2, ... empty
    sessions in a row there were (``kernel_events`` fails only on a run
    of ``ATTEMPTS``), and how many sessions held each number of kernel
    events. The conditions, on a [32 x 8] gate score (the smallest kernel
    the tests profile) unless named:

    * ``drained``: the work drained before each session opens (as
      ``kernel_events`` does);
    * ``in_flight``: a [4096 x 4096] matmul still running on the card
      when the session opens;
    * ``back_to_back``: no drain and no pause between sessions;
    * ``paused``: 50 ms between sessions;
    * ``cpu_and_cuda``: CPU activity traced too;
    * ``one_call``: one call per session (the shortest trace);
    * ``one_step``: one call of 8 [4096 x 4096] matmuls and a gate score
      with CPU activity traced, as ``chip_smoke.py`` profiles a step;
    * ``captures``: ``sessions`` captures of 20 calls as ``kernel_events``
      takes them (``RETRY_PAUSE_S`` before a retry), each up to 10
      attempts: how many captures took each number of attempts;
    * ``captures_no_pause``: the same with no pause before a retry.

    ``only`` names the conditions to run (all by default).
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.confidence_gate import kernel as gate_kernel
    dev = torch.device("cuda")
    x = torch.randn(32, 8, device=dev)
    big = torch.randn(4096, 4096, device=dev)
    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def score():
        return gate_kernel.gate_score(x, "max_softmax")

    def step():
        y = big
        for _ in range(8):
            y = y @ big
        return score()

    def undrained(fn, n):
        with profile(activities=cuda) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return _kernels(prof)

    def in_flight():
        big @ big
        return undrained(score, calls)

    def paused():
        time.sleep(0.05)
        return _session(score, calls, cuda)

    cases = {
        "drained": lambda: _session(score, calls, cuda),
        "in_flight": in_flight,
        "back_to_back": lambda: undrained(score, calls),
        "paused": paused,
        "cpu_and_cuda": lambda: _session(score, calls, both),
        "one_call": lambda: _session(score, 1, cuda),
        "one_step": lambda: _session(step, 1, both),
    }
    step()
    torch.cuda.synchronize()
    for name, pause in (("captures", RETRY_PAUSE_S),
                        ("captures_no_pause", 0.0)):
        if only and name not in only:
            continue
        took = Counter()
        t0 = time.perf_counter()
        for _ in range(sessions):
            took[_capture(score, 20, cuda, 10, pause)[1]] += 1
        yield name, {"captures": sessions,
                     "attempts": dict(sorted(took.items())),
                     "s": time.perf_counter() - t0}
    for name, case in cases.items():
        if only and name not in only:
            continue
        empty = run = 0
        runs, counts = Counter(), Counter()
        t0 = time.perf_counter()
        for _ in range(sessions):
            kern = case()
            counts[sum(e.count for e in kern)] += 1
            if kern:
                if run:
                    runs[run] += 1
                run = 0
            else:
                empty += 1
                run += 1
        if run:
            runs[run] += 1
        yield name, {"sessions": sessions, "empty": empty,
                     "empty_runs": dict(sorted(runs.items())),
                     "kernel_counts": dict(sorted(counts.items())),
                     "s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sessions", type=int, default=1000)
    ap.add_argument("--only", nargs="*", help="the conditions to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")
    for name, row in probe(args.sessions, only=args.only):
        print(json.dumps({"probe": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
