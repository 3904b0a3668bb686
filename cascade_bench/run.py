"""Run one cell of the benchmark once, on the card this process sees.

    python3 cascade_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic mix, limits and metric readers are files under
``cascade_bench/`` found by name (``spec.py``). The run builds the
system under test from the seed (``stack.py``), warms up every shape the
window uses, measures for ``--seconds`` (``loops.py``; with ``--trace 1``
a stretch of it under ``torch.profiler``, ``trace.py``), reads the
cell's metrics (end-to-end ones with ``--trace 0``, per-layer ones with
``--trace 1``), then checks what the window produced against the plain
reference (``check.py``). Its last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines on standard error).

Exits non-zero with no result when there is no CUDA card, or fewer
than the cell asks for, and when JAX, jaxlib, flax or the JAX package
``repro`` is loaded in this process once the window has closed. The
port's kernels build into ``build/`` of the checkout (``src/repro_torch/
kernels/build.py``), so only a checkout's first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import torch  # noqa: E402

from cascade_bench import check, loops, spec, stack  # noqa: E402
from cascade_bench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the metric readers read."""
    window: loops.Window
    capture: object
    mix: dict
    family: object
    widths: dict
    kind: str
    setup_s: float


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def reader(name: str):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"cascade_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, run: Run) -> dict:
    out = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def trace_stretch(mix: dict, seconds: float) -> tuple[float, float]:
    t = mix["trace"]
    start = t["start_frac"] * seconds
    return start, start + t["span_s"]


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, *, control: bool = False, t_start: float | None = None
            ) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, metrics, check.
    Returns the result (see the module's doc), with ``numbers`` holding
    every number compared (and, with ``control``, the control's)."""
    device = torch.device(device)
    t_start = time.perf_counter() if t_start is None else t_start
    mix = cell.traffic
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    sut = stack.build(cell.config, mix, seed, device)
    sut.warm_up()
    setup_s = time.perf_counter() - t_start
    print("[cascade_bench] set-up seconds: " + json.dumps(
        {"before_build": t_build - t_start, **sut.phases.seconds}),
        file=sys.stderr)
    start, stop = trace_stretch(mix, seconds)
    tracer = Tracer(trace, start, stop, device, time.perf_counter)
    win = loops.LOOPS[mix["loop"]](sut, seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    run = Run(window=win, capture=tracer.result() if trace else None,
              mix=mix, family=sut.family, widths=sut.widths, kind=kind,
              setup_s=setup_s)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    t_check = time.perf_counter()
    numbers = check.CHECKS[mix["loop"]](sut, win, cell.limits,
                                        control=control)
    numbers["check_s"] = time.perf_counter() - t_check
    correct, rows = check.judge(numbers["program"], cell.limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(numbers["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and run.capture is not None:
        cap = run.capture
        device_info.update(busy_s=cap.busy_s, window_s=cap.window_s)
        ops = sorted(([n, v[0]] for n, v in cap.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": ops, "idle_gaps": cap.gaps[:10]}
    result["checks"] = rows
    result["numbers"] = numbers
    return result


def _finite(v):
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for the CPU's own tensor work: the port's host
    # half, the transport's workers and the load generator are the
    # process's threads, and idle intra-op workers would contend with them
    torch.set_num_threads(1)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[cascade_bench] needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[cascade_bench] loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    print(f"[cascade_bench] check seconds: "
          f"{result.pop('numbers')['check_s']}", file=sys.stderr)
    result = _finite(result)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
