"""Requests answered over the window, any disposition, over all the
window's seconds (host clock, from the first submit to the last
hand-back)."""


def read(run):
    w = run.window
    return len(w.responses) / w.elapsed_s
