"""The whole step's share of the card's bf16 peak: the model FLOPs of
every remote prefill row sent in the window (the family's ``prefill_flops``:
layers, causal attention, the last position's head; the transport pads
no row, the local tier's padded rows are not counted, nor is the local
tier), over the window's seconds less the profiler's own opening and
closing, times the peak."""

from cascade_bench import flops


def read(run):
    w = run.window
    if not w.remote_rows:
        return None
    seq = run.mix["task"]["seq_len"]
    work = sum(run.family.prefill_flops(run.widths, r, seq)
               for r in w.remote_rows)
    peak = flops.peak(run.kind)["bf16_flops"]
    return 100.0 * work / ((w.elapsed_s - w.overhead_s) * peak)
