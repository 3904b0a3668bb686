"""Answer tokens generated over the window, over all its seconds (host
clock; each call ends with its answers on the host)."""


def read(run):
    w = run.window
    return w.attempted * run.mix["new_tokens"] / w.elapsed_s
