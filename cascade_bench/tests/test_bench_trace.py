"""The trace reduction on a made-up capture: busy time is the union of
the device's operations (a span mirrored onto the device is none), and
the idle labels account for all of the idle time."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from cascade_bench import trace


def _ev(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        is_user_annotation=annotation)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_busy_is_the_union_and_labels_cover_the_idle_time():
    events = [
        _ev("gemm", 100, 400, device=True),
        _ev("gemm", 300, 500, device=True),        # overlaps: union
        _ev("norm", 510, 520, device=True),        # a 10 us gap before
        _ev("gemm", 900, 1000, device=True),       # a 380 us gap before
        _ev("bench.remote_prefill", 0, 2000, device=True, annotation=True),
        _ev("bench.remote_prefill", 0, 2000),
        _ev("aten::mm", 600, 800),
        _ev("cudaLaunchKernel", 650, 700),       # innermost, but not at 710
    ]
    cap = trace.analyse(_Prof(events), window_s=0.0012)
    assert cap.busy_s == pytest.approx((400 + 10 + 100) * 1e-6)
    assert cap.kernels["gemm"][0] == pytest.approx(600e-6)
    assert cap.kernels["gemm"][1] == 3
    labels = dict(cap.gaps)
    # the gap's middle (710 us) falls in aten::mm, not in the launch
    assert labels["bench.remote_prefill/aten::mm"] == pytest.approx(380e-6)
    assert labels["gaps under 20 us between device ops"] == \
        pytest.approx(10e-6)
    assert sum(labels.values()) == pytest.approx(0.0012 - cap.busy_s)
    assert "bench.remote_prefill" not in cap.kernels


def test_no_device_op_is_no_capture():
    assert trace.analyse(_Prof([_ev("aten::mm", 0, 10)]), 1.0) is None


def test_tracer_is_off_without_a_card():
    import torch
    t = trace.Tracer(True, 0.0, 1.0, torch.device("cpu"), lambda: 0.0)
    t.boundary(5.0, {})
    t.finish({})
    assert t.result() is None and t.overhead_s == 0.0
