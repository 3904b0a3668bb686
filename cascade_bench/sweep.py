"""The sweep that fixes an open-loop mix's rate: how fast the cascade
serves the mix's traffic without a growing backlog.

For each offered rate, builds the cell's system anew (so no request of
an earlier rate sits in the response cache) and runs its ``poisson``
loop, then prints one JSON line: the rate offered and completed, the
latency percentiles from the due time, and the median latency of the
first and the last fifth of the requests (a backlog that grows through
the run shows as the last fifth's far above the first's).

    python3 cascade_bench/sweep.py --workload yi-6b.reviews512.poisson \\
        --seconds 15 --rates 100 150 200
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cascade_bench import loops, spec, stack  # noqa: E402
from cascade_bench.trace import Tracer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda")
    for rate in args.rates:
        mix = copy.deepcopy(cell.traffic)
        mix["rate"] = rate
        sut = stack.build(cell.config, mix, args.seed, dev)
        sut.warm_up()
        tracer = Tracer(False, 0.0, 0.0, dev, stack.now)
        win = loops.poisson(sut, args.seconds, tracer)
        sut.close()
        lat = np.asarray(win.latencies_s) * 1e3
        fifth = max(1, lat.size // 5)
        print(json.dumps({
            "rate": rate, "requests": int(lat.size),
            "completed_per_s": len(win.responses) / win.elapsed_s,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "first_fifth_p50_ms": float(np.median(lat[:fifth])),
            "last_fifth_p50_ms": float(np.median(lat[-fifth:])),
            "lag_p95_ms": float(np.percentile(win.lags_s, 95)) * 1e3,
            "drain_s": win.elapsed_s - args.seconds}), flush=True)
        del sut, win
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
