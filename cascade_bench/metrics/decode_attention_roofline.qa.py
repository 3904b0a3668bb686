"""The decode-attention kernel's share of its roofline over the traced
stretch (whole generate calls): the sum over its calls of
``flops.decode_attn_bound_s`` (one call a layer a decode step, over the
step's valid slots), over the device time of its kernels (the split
pass and the combine) summed over the trace. Silent when the trace holds
another number of split calls than the steps made."""

from cascade_bench import flops


def read(run):
    cap = run.capture
    if cap is None or "calls" not in cap.marks:
        return None
    c0, c1 = cap.marks["calls"]
    m, L = run.mix, run.widths["layers"]
    steps = m["new_tokens"] - 1
    split = [v for n, v in cap.kernels.items() if "decode_split" in n]
    t = sum(v[0] for n, v in cap.kernels.items() if "decode_" in n)
    if c1 <= c0 or sum(v[1] for v in split) != (c1 - c0) * steps * L or t <= 0:
        return None
    per_call = sum(L * flops.decode_attn_bound_s(
        run.widths, m["batch"], m["prompt_len"] + i + 1, run.kind)
        for i in range(steps))
    return 100.0 * (c1 - c0) * per_call / t
