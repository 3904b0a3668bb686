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
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from collections.abc import Callable

import torch

__all__ = ["ATTEMPTS", "CAPTURES", "EmptyTraceError", "device_us",
           "kernel_events"]

# Empty sessions come in runs, as if the tracer lost a window of ~0.1 s
# now and then (counted on an H100: 0.1-0.4 empty a second of tracing,
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


def kernel_events(fn: Callable[[], object], calls: int = 20,
                  cpu: bool = False) -> list:
    """The device kernel events of ``calls`` calls of ``fn`` (see the
    module's docstring), with CPU activity traced too if ``cpu``; raises
    ``EmptyTraceError`` after ``ATTEMPTS`` empty captures."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, ATTEMPTS + 1):
        if attempt > 1:
            time.sleep(RETRY_PAUSE_S)
        kern = _session(fn, calls, acts)
        if kern:
            with _LOCK:
                CAPTURES[attempt] += 1
            return kern
    raise EmptyTraceError(
        f"torch.profiler recorded no device kernel in {ATTEMPTS} captures "
        f"of {calls} calls")

