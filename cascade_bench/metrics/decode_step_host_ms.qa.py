"""The host's time to queue one decode step: the mean host seconds of
the program's ``generate.step`` spans (a step and its token's pick)
over the traced stretch (``spans.tally``). Silent unless their count is
the traced generate calls times ``new_tokens - 1``."""

from cascade_bench import spans


def read(run):
    t = spans.tally(run)
    if t is None:
        return None
    calls = spans.marked(run, "calls")
    n, s = t.get(("span_seconds", "generate.step"), (0, 0.0))
    if not calls or not n or n != calls * (run.mix["new_tokens"] - 1):
        return None
    return 1e3 * s / n
