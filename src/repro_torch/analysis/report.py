"""Render the port's dry-run JSONL (``launch.dryrun --json``) into the
§Dry-run / §Roofline markdown tables, as ``repro.analysis.report``.

    PYTHONPATH=src python -m repro_torch.analysis.report results.jsonl

The per-chip column reads each record's argument bytes (its unit comes
from the records: bytes a chip, beside the H100's 80 GB).
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def fmt_s(x) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(rows) -> str:
    out = ["| arch | shape | mesh | status | compile | args/chip | "
           "bottleneck |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "ok":
            mem = r.get("memory", {})
            rf = r.get("roofline", {})
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                f"{r.get('compile_s', '-')}s | "
                f"{fmt_bytes(mem.get('argument_size_in_bytes'))} | "
                f"{rf.get('bottleneck', '-')} |")
        elif r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"skip | - | - | {r['reason']} |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAIL | - | - | - |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | compute | memory | collective | bottleneck | "
           "MODEL_FLOPS | useful |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['bottleneck']}** | {rf['model_flops']:.2e} | "
            f"{rf['useful_ratio']:.2f} |")
    return "\n".join(out)


def interesting_pairs(rows) -> list[dict]:
    """The hillclimb candidates: worst useful-ratio (roofline fraction)
    and most collective-bound."""
    ok = [r for r in rows
          if r["status"] == "ok" and r["mesh"] == "single"]
    worst = min(ok, key=lambda r: r["roofline"]["useful_ratio"]
                if r["roofline"]["useful_ratio"] == r["roofline"]
                ["useful_ratio"] else 9e9)
    coll = max(ok, key=lambda r: (r["roofline"]["collective_s"]
                                  / max(max(r["roofline"]["compute_s"],
                                            r["roofline"]["memory_s"]),
                                        1e-12)))
    return [worst, coll]


def main(path: str) -> None:
    rows = [json.loads(l) for l in open(path)]
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    print(f"## §Dry-run ({n_ok} ran, {n_skip} principled skips, "
          f"{sum(r['status'] == 'fail' for r in rows)} failures)\n")
    print(dryrun_table(rows))
    print("\n## §Roofline (single-pod 16x16 = 256 H100s)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "dryrun.jsonl")
