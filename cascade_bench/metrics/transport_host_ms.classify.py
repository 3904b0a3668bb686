"""The transport window on the host over the traced stretch: the mean
host seconds of the program's ``transport.window`` spans (a window of
escalated rows sent, answered and brought back, retries included;
``spans.tally``). ``remote_stream_ms.classify`` reads the same
stretch's remote prefills on the card's stream. Silent unless the
``transport.window`` count equals the remote prefills the loop counted
across the stretch."""

from cascade_bench import spans


def read(run):
    t = spans.tally(run)
    if t is None or not spans.sent_all(run, t):
        return None
    n, s = t[("span_seconds", "transport.window")]
    return 1e3 * s / n
