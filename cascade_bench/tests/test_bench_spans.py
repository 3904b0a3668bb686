"""The readers of the program's spans (``spans.py`` and the metrics that
use it) on made-up runs: each reads ``SPANS`` over one capture of the
stretch, and is silent without one, after a retried capture, when its
count check fails, and with a program that has no ``SPANS``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from cascade_bench import run as bench_run

CLASSIFY = ("engine_host_ms.classify", "remote_stream_ms.classify",
            "transport_host_ms.classify")


@pytest.fixture
def spans(monkeypatch):
    """A fresh ``SPANS`` in the program's observability module."""
    from repro_torch.runtime import observability
    reg = observability.MetricsRegistry()
    monkeypatch.setattr(observability, "SPANS", reg, raising=False)

    def put(name, *seconds, metric="span_seconds"):
        for s in seconds:
            reg.histogram(metric, span=name).observe(s)
    return put


def _run(marks, attempts=1, captured=True, new_tokens=32):
    cap = (SimpleNamespace(marks=marks, attempts=attempts) if captured
           else None)
    return SimpleNamespace(capture=cap, mix={"new_tokens": new_tokens})


def _classify(put, windows=2, sent=4):
    put("cascade.window", *[0.150] * windows)
    put("cascade.gate_wait", *[0.010] * windows)
    put("cascade.remote_wait", *[0.100] * windows)
    put("cascade.host_half", *[0.105] * windows)     # nests the wait
    put("transport.window", *[0.050] * sent)
    put("transport.attempt", *[0.020] * sent, metric="span_device_seconds")


def test_classify_readers_read_the_stretch(spans):
    _classify(spans)
    run = _run({"remote_calls": (10, 14)})
    host = bench_run.reader("engine_host_ms.classify")(run)
    assert host == pytest.approx(40.0)        # 150 - 10 - 100 ms
    assert bench_run.reader("remote_stream_ms.classify")(run) == \
        pytest.approx(20.0)
    assert bench_run.reader("transport_host_ms.classify")(run) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("name", CLASSIFY)
@pytest.mark.parametrize("case", ["no capture", "retried", "count",
                                  "no remote call"])
def test_classify_readers_are_silent(spans, name, case):
    _classify(spans)
    run = {"no capture": _run({}, captured=False),
           "retried": _run({"remote_calls": (10, 14)}, attempts=2),
           "count": _run({"remote_calls": (10, 15)}),
           "no remote call": _run({"remote_calls": (10, 10)})}[case]
    assert bench_run.reader(name)(run) is None


def test_stream_reader_is_silent_without_device_spans(spans):
    spans("cascade.window", 0.1)
    spans("transport.window", 0.05, 0.05)
    run = _run({"remote_calls": (0, 2)})
    assert bench_run.reader("remote_stream_ms.classify")(run) is None
    assert bench_run.reader("engine_host_ms.classify")(run) == \
        pytest.approx(100.0)


def test_decode_step_reader(spans):
    spans("generate.step", *[0.004] * 31, *[0.006] * 31)
    spans("generate.prefill", 1.0)
    read = bench_run.reader("decode_step_host_ms.qa")
    assert read(_run({"calls": (3, 5)})) == pytest.approx(5.0)
    assert read(_run({"calls": (3, 4)})) is None          # 62 != 31
    assert read(_run({"calls": (3, 5)}, attempts=3)) is None
    assert read(_run({"calls": (3, 5)}, captured=False)) is None
    assert read(_run({"calls": (3, 3)})) is None


def test_decode_step_reader_is_silent_with_one_token(spans):
    read = bench_run.reader("decode_step_host_ms.qa")
    assert read(_run({"calls": (0, 1)}, new_tokens=1)) is None


@pytest.mark.parametrize("name", CLASSIFY + ("decode_step_host_ms.qa",))
def test_readers_are_silent_on_a_program_without_spans(monkeypatch, name):
    from repro_torch.runtime import observability
    monkeypatch.delattr(observability, "SPANS", raising=False)
    run = _run({"remote_calls": (0, 4), "calls": (0, 1)})
    assert bench_run.reader(name)(run) is None
