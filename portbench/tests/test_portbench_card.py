"""The benchmark's cells on the card (marked `gpu`; they skip without a CUDA
device): a short run of each cell is correct, and the control at the cell's
own size fails a limit. On the chip:

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""
from __future__ import annotations

import contextlib
import io
import json

import pytest

import control
import run
from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(cuda, workload):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", workload, "--seed", "2147483659", "--seconds", "3"]) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(cuda, workload):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert control.main(["--workload", workload, "--seeds", "5"]) == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    cell = run.spec.Cell(workload, REPO)
    assert any(row[k] > lim for k, lim in cell.cfg["limits"].items() if k in row), row
