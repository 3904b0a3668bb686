"""``BENCHMARK.json`` and the files it names: every cell's configuration,
mix, limits and metric readers resolve by name, and every name and unit
keeps to the allowed characters."""

from __future__ import annotations

import json
import re

import pytest

from cascade_bench import spec

BENCH = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
TEXT = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["cascade_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = spec.cell(w["name"])
    assert cell.chips == 1
    assert cell.traffic["loop"] in ("backlog", "poisson", "qa")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert cell.limits


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_is_its_own(c):
    assert c["file"] == f"cascade_bench/configs/{c['name']}.json"
    cfg = spec.model_config(c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []


def test_names_units_and_text():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert spec.NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert spec.UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.fullmatch(c["why"]) and TEXT.fullmatch(c["source"])
        assert all(spec.NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
        assert TEXT.fullmatch(w["why"])
    for m in BENCH["per_layer"]:
        assert TEXT.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for word in BENCH["command"]:
        assert TEXT.fullmatch(word)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_report_beside_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("change", [
    {"use_sliding_window": True}, {"tie_word_embeddings": True},
    {"hidden_act": "gelu"}, {"rope_scaling": {"type": "yarn"}},
    {"sliding_window": 4096, "use_sliding_window": None},
    {"family": "no_such_family"}])
def test_a_config_the_family_does_not_implement_is_refused(change):
    from cascade_bench.reference import family
    cfg = {**spec.model_config("qwen2-7b"), **change}
    cfg = {k: v for k, v in cfg.items() if v is not None}
    with pytest.raises((ValueError, ImportError)):
        family(cfg)
    for c in BENCH["configs"]:
        family(spec.model_config(c["name"]))
