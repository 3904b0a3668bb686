"""What one cell is: its entry in ``BENCHMARK.json`` and the data files
that the harness finds by the names there.

* ``configs/<config>.json``: the model, with Hugging Face's key names
  (``hidden_size``, ``num_key_value_heads``, ...), as it is run;
* ``traffic/<traffic>.json``: the mix, read by the general loops of
  ``loops.py`` (its ``loop`` key picks one);
* ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``metrics/<metric>.py``: one reader per metric (``read(run)``).

A cell, a configuration, a mix or a metric is added by adding files.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(kind: str, name: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return BENCH_DIR / kind / f"{name}.json"


def model_config(name: str) -> dict:
    return load_json(_named("configs", name))


def traffic(name: str) -> dict:
    return load_json(_named("traffic", name))


def limits(workload: str) -> dict:
    return load_json(_named("cells", workload))["limits"]


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files resolved."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, workload) and m["moves"] in names]
    return Cell(name=workload, config=model_config(entry["config"]),
                traffic=traffic(entry["traffic"]), limits=limits(workload),
                chips=entry["chips"], end_to_end=e2e, per_layer=layer)
