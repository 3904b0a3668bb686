"""The control, the reference in the program's place one precision down
(the remote tier in float8 e4m3, the local tier in TF32), comes out not
correct where the program comes out correct.

On the card (marker ``cuda``) at each cell's own size, one seed; on the
CPU at tiny sizes, that the control's errors stand well above the
program's."""

from __future__ import annotations

import pytest
import torch

from cascade_bench import check, run, spec
from cascade_bench.tests.conftest import tiny_cell

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cell = spec.cell(workload)
    r = run.execute(cell, 2 ** 31 + 4242, 5.0, False, "cuda", control=True)
    assert r["correct"], r["checks"]
    ok, rows = check.judge(r["numbers"]["control"], cell.limits)
    assert not ok, rows


@pytest.mark.parametrize("workload", ["yi-6b.reviews512.backlog",
                                      "yi-6b.squad256.qa256"])
def test_control_departs_further_than_the_program(workload):
    r = run.execute(tiny_cell(workload), 2 ** 31 + 99, 1.5, False, "cpu",
                    control=True)
    prog, ctrl = r["numbers"]["program"], r["numbers"]["control"]
    key = ("remote_logits_err" if "remote_logits_err" in prog
           else "token_gap")
    assert ctrl[key] > 3 * prog[key], (prog, ctrl)
