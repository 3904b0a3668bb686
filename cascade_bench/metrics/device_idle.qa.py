"""The device's idle share of the traced stretch: 1 - busy / length,
busy being the union of the intervals in which an operation ran on the
card (``torch.profiler``'s device events)."""


def read(run):
    cap = run.capture
    if cap is None or cap.window_s <= 0:
        return None
    return 100.0 * (1.0 - cap.busy_s / cap.window_s)
