"""The remote prefill's time on its CUDA stream: the mean elapsed time
of the CUDA event pair that the program's ``transport.attempt`` span
records around ``remote_apply`` on the attempt thread's stream
(``spans.tally``), from the stream reaching the prefill's first work to
its last kernel's end. It is not the kernels' busy time: idle gaps
between launches are in it, so where the prefill is launch-bound (as
under the profiler) it follows the attempt thread's host. Beside
``transport_host_ms.classify`` (the same stretch's transport windows on
the host) it splits a window into stream time and the rest. Silent
unless the ``transport.window`` count equals the remote prefills the
loop counted across the stretch."""

from cascade_bench import spans


def read(run):
    t = spans.tally(run)
    if t is None or not spans.sent_all(run, t):
        return None
    n, s = t.get(("span_device_seconds", "transport.attempt"), (0, 0.0))
    return 1e3 * s / n if n else None
