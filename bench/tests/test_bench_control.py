"""The control: the reference with float8 products in the program's place
reads further from the float32 reference than the program does.

On the CPU at the port's smoke sizes in bfloat16 (what a test run can
hold); on a card (``-m cuda``) at the cell's own size and load, where its
numbers have to fail the cell's limits and the program's pass them."""

import json
import time

import pytest
import torch

import control
import correct
import harness
from helpers import BENCHMARK, smoke_cell


@pytest.mark.parametrize("name", ["codeqwen-completion", "jamba-summarize"])
def test_control_reads_above_the_program(name):
    cell = smoke_cell(name, "bfloat16")
    out = harness.run(cell, 2**31 + 5, 0.0, False, "cpu", time.perf_counter(), min_waves=2)
    ctrl = correct.combine([control.control_arrays(cell, out["weights"], w, "cpu") for w in out["kept"]])
    prog = correct.check(cell, out["weights"], out["kept"], "cpu")
    assert ctrl["served_err"] > 2 * prog["served_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCHMARK["workloads"]])
def test_control_fails_the_limits_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.Cell.load(BENCHMARK, name)
    row = control.readings(cell, 2**31 + 77, True, "cuda")
    ok, _ = correct.judge(row["program"], cell.limits)
    bad, _ = correct.judge(row["control"], cell.limits)
    assert ok and not bad, json.dumps(row)
