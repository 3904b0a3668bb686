"""The flash-attention prefill kernel's share of its roofline over the
traced stretch: the sum over its calls of ``flops.flash_bound_s`` (one
call a layer a remote prefill, from the rows the harness sent), over the
kernel's device time summed over its calls in the trace. Silent when the
trace holds another number of calls than were made (a dropped event
would inflate the share)."""

from cascade_bench import flops


def read(run):
    cap = run.capture
    if cap is None or "remote_calls" not in cap.marks:
        return None
    i0, i1 = cap.marks["remote_calls"]
    rows = run.window.remote_rows[i0:i1]
    L = run.widths["layers"]
    k = [v for n, v in cap.kernels.items() if "flash_" in n]
    t, count = sum(v[0] for v in k), sum(v[1] for v in k)
    if not rows or count != L * len(rows) or t <= 0:
        return None
    seq = run.mix["task"]["seq_len"]
    bound = sum(L * flops.flash_bound_s(run.widths, r, seq, run.kind)
                for r in rows)
    return 100.0 * bound / t
