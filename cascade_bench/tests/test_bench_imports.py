"""No module of the benchmark loads JAX or the JAX package: each is
imported in a fresh interpreter in which importing a module whose
top-level name (the part before the first dot) is ``jax``, ``jaxlib``,
``flax`` or ``repro`` raises. ``repro_torch`` passes: the names are
compared whole."""

from __future__ import annotations

import subprocess
import sys

import pytest

from cascade_bench.spec import BENCH_DIR, ROOT

GUARD = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [{src!r}, {root!r}]
"""

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in BENCH_DIR.rglob("*.py")
    if "tests" not in p.parts and "metrics" not in p.parts)
METRICS = sorted(p for p in (BENCH_DIR / "metrics").glob("*.py"))


def _run(code: str):
    guard = GUARD.format(src=str(ROOT / "src"), root=str(ROOT))
    return subprocess.run([sys.executable, "-c", guard + code],
                          capture_output=True, text=True, timeout=300)


def test_the_guard_refuses_repro_and_passes_repro_torch():
    bad = _run("import repro")
    assert bad.returncode != 0 and "refused: repro" in bad.stderr
    good = _run("import repro_torch.serving")
    assert good.returncode == 0, good.stderr


def test_every_module_imports_without_jax_or_repro():
    loads = "".join(f"import {m}\n" for m in MODULES)
    loads += "import importlib.util\n"
    for i, p in enumerate(METRICS):
        loads += (f"s = importlib.util.spec_from_file_location('m{i}', "
                  f"{str(p)!r}); importlib.util.module_from_spec(s); "
                  f"s.loader.exec_module(importlib.util.module_from_spec(s))"
                  "\n")
    # the program the harness drives, as a run loads it
    loads += ("import repro_torch.launch.serve, repro_torch.serving."
              "generate\n")
    loads += ("bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'repro')]\nassert not bad, bad\n")
    r = _run(loads)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("name,bad", [("repro_torch.serving", False),
                                      ("repro.serving", True),
                                      ("jaxlib", True), ("flax.linen", True),
                                      ("reproduce", False)])
def test_forbidden_modules_compares_whole_top_level_names(name, bad,
                                                          monkeypatch):
    from cascade_bench import run
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) is bad
