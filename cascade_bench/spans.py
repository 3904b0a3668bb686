"""The program's span tally over the traced stretch, for the per-layer
readers of ``metrics/``.

``repro_torch.runtime.observability.SPANS`` holds, per span name, the
host seconds (``span_seconds``) and, for spans timed on the card, the
device seconds (``span_device_seconds``) of every span that ran, on any
thread, while a profiler recorded: in a run, the traced stretch's
captures. ``tally`` reads it only when the stretch took one capture (an
empty capture's spans would be in the tally too), and a reader holds the
tally's counts to what the loop counted across the stretch. A program
without ``SPANS`` gives no tally.
"""

from __future__ import annotations


def tally(run) -> dict | None:
    """``{(metric, span): (count, seconds)}``, or None (see above)."""
    cap = run.capture
    if cap is None or cap.attempts != 1:
        return None
    from repro_torch.runtime import observability
    spans = getattr(observability, "SPANS", None)
    if spans is None:
        return None
    out = {}
    for key, h in spans.snapshot()["histograms"].items():
        metric, _, labels = key.partition("{")
        if labels.startswith('span="'):
            out[metric, labels[len('span="'):-2]] = (h["count"], h["sum"])
    return out


def marked(run, mark: str) -> int | None:
    """How far the loop's counter ``mark`` moved across the stretch."""
    got = run.capture.marks.get(mark)
    return None if got is None else got[1] - got[0]


def sent_all(run, t: dict) -> bool:
    """Whether the tally's ``transport.window`` count equals the remote
    prefills the loop counted across the stretch (at least one)."""
    n_remote = marked(run, "remote_calls")
    sent = t.get(("span_seconds", "transport.window"), (0, 0.0))[0]
    return bool(n_remote) and sent == n_remote
