"""The readings that the limits of ``cells/*.json`` are set from.

Runs one cell on many seeds in one process (the kernels load once) with
a short window, and prints for each seed one JSON line: every number the
check compares, for the program and for the control (the reference put
in the program's place one precision down; ``check.py``), with the
run's ``correct`` under the cell's current limits. The benchmark's own
runs never run the control.

    python3 cascade_bench/readings.py --workload yi-6b.reviews512.backlog \\
        --seconds 5 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from cascade_bench import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        r = run.execute(cell, seed, args.seconds, False, "cuda",
                        control=True)
        print(json.dumps(run._finite({
            "workload": args.workload, "seed": seed,
            "correct": r["correct"], "numbers": r["numbers"],
            "metrics": r["metrics"],
            "memory_peak_bytes": r["device"]["memory_peak_bytes"]})),
            flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
