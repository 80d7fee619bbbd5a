"""``correct`` at a size a CPU test holds: a sound run passes; the timed
path broken underneath, in each way a cell can break, fails; and the
control (the reference in bfloat16 in the program's place) fails the same
limits.  The harness's look for a card is skipped: the run is driven on
the CPU through ``harness.execute``."""

import time

import pytest
import torch

import repro_torch.api.operator as operator_mod
import repro_torch.core.solver as solver_mod
from ehyb_bench import harness
from ehyb_bench.reference.control import ControlOperator
from ehyb_bench.reference.rows import PaddedRows
from ehyb_bench.tiny import tiny_cell

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def run(cell):
    return harness.execute(cell, seed=2 ** 31 + 9, seconds=0.2, trace=False,
                           device="cpu", t_start=time.perf_counter())[0]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run(tiny_cell(workload))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"      # last key of the result line


def _solver_fault(kind):
    real = solver_mod.SOLVERS["cg"]

    def cg(*args, **kw):
        res = real(*args, **kw)
        x = res.x.clone()
        if kind == "state unchanged":       # every step left x where it was
            x.zero_()
        else:                               # one entry of the answer
            x[0] += x.abs().max()
        return res._replace(x=x)
    return cg


def _apply_fault(kind):
    real = operator_mod.apply_operator

    def apply(*args, **kw):
        y = real(*args, **kw).clone()
        if kind == "half the batch left out":
            y[:, y.shape[1] // 2:] = 0
        else:
            y.view(-1)[0] += y.abs().max()
        return y
    return apply


FAULTS = [("hpcg_128.cg", "state unchanged"),
          ("hpcg_128.cg", "answer altered"),
          ("elast_q1_64.spmv", "answer altered"),
          ("elast_q1_64.spmm16", "answer altered"),
          ("elast_q1_64.spmm16", "half the batch left out")]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload)
    if cell.traffic["loop"] == "cg":
        monkeypatch.setitem(solver_mod.SOLVERS, "cg", _solver_fault(fault))
    else:
        monkeypatch.setattr(operator_mod, "apply_operator",
                            _apply_fault(fault))
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    cell = tiny_cell(workload)
    matrix = harness.make_matrix(cell, "cpu")
    loop = harness._module("loops", cell.traffic["loop"])
    inputs = loop.make_inputs(cell.traffic, matrix.n, torch.float32, 4,
                              torch.device("cpu"))
    answers = loop.control_answers(ControlOperator(matrix, "cpu"), inputs,
                                   cell.traffic)
    checks = harness.judge(cell, loop, PaddedRows(matrix, "cpu"), inputs,
                           answers)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
