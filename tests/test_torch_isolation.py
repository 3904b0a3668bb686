"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``repro``.

One test imports every module of the port in a fresh interpreter where
``import jax`` fails and a finder refuses ``repro`` and ``repro.*``; the
parametrised tests read each source file's import statements.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m, mod in sys.modules.items() if mod is not None
               and (m == "repro" or m.startswith(("repro.", "jax")))]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


@pytest.mark.parametrize("module", ["repro_torch.models.mamba2",
                                    "repro_torch.models.frontend"])
def test_family_module_imports_alone_without_jax_or_repro(module):
    """The zamba and frontend families' modules, each imported first and
    alone in a fresh interpreter that refuses ``jax`` and ``repro``, and
    run there: a mamba2 state and a frontend embedding on the CPU."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path[:0] = [{str(ROOT / "src")!r}]
        mod = importlib.import_module({module!r})
        from repro_torch.configs import get_config
        if mod.__name__.endswith("mamba2"):
            st = mod.mamba2_state(get_config("zamba2-7b").reduced(), 1)
            assert st["ssm"].shape[-2:] == (mod.HEAD_P, 64)
        else:
            x = mod.frontend_embeddings(get_config("hubert-xlarge"), 1, 2,
                                        device="cpu")
            assert tuple(x.shape) == (1, 2, 1280)
        bad = [m for m, mod in sys.modules.items() if mod is not None
               and (m == "repro" or m.startswith(("repro.", "jax")))]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    bad = {n for n in _imported(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, bad


def test_every_kernel_source_names_what_it_replaces():
    for cu in sorted((PORT / "csrc").glob("*.cu")):
        head = cu.read_text()[:1500]
        assert "Replaces src/repro/kernels/" in head, cu.name
        assert "Bound on the H100" in head and "Design." in head, cu.name
