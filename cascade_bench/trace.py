"""The device trace of a steady stretch of the window (``--trace 1``).

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over a
stretch of the window, from the first loop boundary after ``start_s`` to
the first after ``stop_s`` or the window's close, so that a long window
does not make a trace of millions of events. A capture that holds no
device event is taken again at a later boundary inside the window, up to
``ATTEMPTS`` captures, at least ``RETRY_PAUSE_S`` after the empty one:
the retry of the port's ``kernels/profiling.py`` (the tracer loses a
~0.1 s window now and then), copied here so that the program cannot move
it. A capture closed at the window's close cannot be retried. The
seconds spent opening and closing captures inside the window are kept in
``overhead_s``, for the rates of a traced run to leave out.

``analyse`` turns a capture into what the metrics read: the device's
busy seconds (the union of its operations' intervals) against the
stretch's length, each kernel's device seconds and count by name, and
the idle time by what the host was doing in it: each gap of at least
``MIN_GAP_US`` between device operations labelled by the innermost host
event across its middle, under the innermost ``bench.*`` span of the
harness across it; the shorter gaps, and the stretch's edges, summed
under their own labels, so that the labels account for all of the idle
time.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

import torch

ATTEMPTS = 5
RETRY_PAUSE_S = 0.25
MIN_GAP_US = 20.0


@dataclass
class Capture:
    window_s: float
    busy_s: float
    kernels: dict            # name -> [device seconds, count]
    gaps: list               # [label, seconds], longest total first
    marks: dict = field(default_factory=dict)   # loop counters at start/stop
    attempts: int = 1


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card, not a
    ``record_function`` span mirrored onto the device's timeline."""
    name = getattr(e, "name", None) or getattr(e, "key", "")
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not name.startswith("bench."))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost_at(events, points):
    """For each point (ascending), the name of the latest-started event
    still running across it (the innermost of nested ones), or None."""
    out, heap, i = [], [], 0
    for m in points:
        while i < len(events) and events[i].time_range.start <= m:
            e = events[i]
            heapq.heappush(heap, (-e.time_range.start, i))
            i += 1
        while heap and events[heap[0][1]].time_range.end < m:
            heapq.heappop(heap)
        out.append(events[heap[0][1]].name if heap else None)
    return out


def analyse(prof, window_s: float) -> Capture | None:
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    if not dev:
        return None
    kernels: dict = defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = kernels[e.name]
        k[0] += (e.time_range.end - e.time_range.start) * 1e-6
        k[1] += 1
    merged = _merge((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(t - s for s, t in merged) * 1e-6
    host = sorted((e for e in events
                   if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=lambda e: e.time_range.start)
    spans = [e for e in host if e.name.startswith("bench.")]
    ops = [e for e in host if not e.name.startswith("bench.")]
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                  for a, b in zip(merged, merged[1:]))
    long = [(m, us) for m, us in gaps if us >= MIN_GAP_US]
    mids = [m for m, _ in long]
    by_label: dict = defaultdict(float)
    for (_, us), op, span in zip(long, _innermost_at(ops, mids),
                                 _innermost_at(spans, mids)):
        op = op or "host, no op traced"
        by_label[f"{span}/{op}" if span else op] += us * 1e-6
    between = sum(us for _, us in gaps) * 1e-6
    by_label[f"gaps under {MIN_GAP_US:g} us between device ops"] += sum(
        us for _, us in gaps if us < MIN_GAP_US) * 1e-6
    by_label["before the first and after the last device op"] += max(
        0.0, window_s - busy - between)
    return Capture(window_s=window_s, busy_s=busy, kernels=dict(kernels),
                   gaps=sorted(([k, v] for k, v in by_label.items() if v > 0),
                               key=lambda kv: -kv[1]))


class Tracer:
    """Profiles from the first boundary after ``start_s`` to the first
    after ``stop_s`` (seconds into the window); ``boundary(elapsed,
    marks)`` is called between loop units with the loop's counters,
    ``finish(marks)`` when the window has closed."""

    def __init__(self, enabled: bool, start_s: float, stop_s: float,
                 device: torch.device, clock):
        self.enabled = enabled and device.type == "cuda"
        self.start_s, self.stop_s, self.device = start_s, stop_s, device
        self.clock = clock
        self.overhead_s = 0.0
        self.prof = None
        self.done = not self.enabled
        self.attempts = 0
        self.kept = None                # (prof, window_s, marks)
        self._t0 = 0.0
        self._retry_at = 0.0
        self._marks: dict = {}

    def boundary(self, elapsed: float, marks: dict) -> None:
        if self.done:
            return
        t = self.clock()
        if self.prof is not None:
            if elapsed >= self.stop_s:
                self._stop(marks, elapsed)
        elif elapsed >= max(self.start_s, self._retry_at):
            self._start(marks)
        else:
            return
        self.overhead_s += self.clock() - t

    def _start(self, marks: dict) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.attempts += 1
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._marks = dict(marks)
        self._t0 = self.clock()

    def _stop(self, marks: dict, elapsed: float) -> None:
        torch.cuda.synchronize(self.device)
        window_s = self.clock() - self._t0
        self.prof.__exit__(None, None, None)
        kept = self.prof
        self.prof = None
        has_device = any(_is_device(e) for e in kept.events())
        if has_device:
            self.kept = (kept, window_s,
                         {k: (self._marks[k], marks[k]) for k in marks})
            self.done = True
        elif self.attempts >= ATTEMPTS:
            self.done = True
        else:
            self._retry_at = elapsed + RETRY_PAUSE_S

    def finish(self, marks: dict) -> None:
        """Close a capture still open at the window's close."""
        if self.prof is not None:
            self._stop(marks, float("inf"))

    def result(self) -> Capture | None:
        """The kept capture, analysed (after the window: not timed)."""
        if self.kept is None:
            return None
        prof, window_s, marks = self.kept
        cap = analyse(prof, window_s)
        if cap is not None:
            cap.marks, cap.attempts = marks, self.attempts
        return cap
