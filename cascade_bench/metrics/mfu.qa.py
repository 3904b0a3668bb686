"""The whole step's share of the card's bf16 peak: the FLOPs of every
generate call of the window (``flops.generate_flops``: the prefill, then
each decode step with its full-vocabulary head; no padded row), over the
window's seconds less the profiler's own opening and closing, times the
peak."""

from cascade_bench import flops


def read(run):
    w, m = run.window, run.mix
    if not w.calls:
        return None
    work = w.calls * flops.generate_flops(run.family, run.widths, m["batch"],
                                          m["prompt_len"], m["new_tokens"])
    peak = flops.peak(run.kind)["bf16_flops"]
    return 100.0 * work / ((w.elapsed_s - w.overhead_s) * peak)
