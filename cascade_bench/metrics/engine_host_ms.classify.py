"""The engine's own host time a local window: the host seconds of the
program's ``cascade.window`` spans (a window packed, served and handed
back), less what they wait on (``cascade.gate_wait``: the local tier and
the gate on the card; ``cascade.remote_wait``: the remote tier), over
the windows (``spans.tally``). Silent unless the ``transport.window``
count equals the remote prefills the loop counted across the stretch."""

from cascade_bench import spans


def read(run):
    t = spans.tally(run)
    if t is None or not spans.sent_all(run, t):
        return None
    windows, win_s = t.get(("span_seconds", "cascade.window"), (0, 0.0))
    if not windows:
        return None
    waits = sum(t.get(("span_seconds", f"cascade.{w}"), (0, 0.0))[1]
                for w in ("gate_wait", "remote_wait"))
    return 1e3 * (win_s - waits) / windows
