"""The comparison separates the program from its control at a size a test
run holds: the reference put in the program's place and computed as float8
products, forward and backward (the precision below the bf16 the
configurations state), reads ``correct`` false by the cell's own limits and
at least three times what the program reads on a number the cell compares;
so does a training step whose loss leaves out half of the batch. On the
card the same holds at the cells' own sizes (PERF.md, section 2)."""

import pytest
import torch
from conftest import tiny

from nerfbench import control, harness


@pytest.mark.parametrize("workload,side", [
    ("fern-train", "control"), ("fern-train", "half"),
    ("lego-serve", "control"),
    ("fern-serve", "control")])
def test_the_control_reads_far_above_the_program(workload, side):
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, workload)
    small = tiny(harness.load("configs", cell["config"]))
    read = lambda s: control.read(bench, cell, s, 2 ** 31 + 55,  # noqa
                                  1.0, torch.device("cpu"), small)
    prog, other = read("program"), read(side)
    assert not control.judged(cell, other), other
    compared = [k for k, v in harness.load("cells", workload)["limits"]
                .items() if v is not None]
    assert any(other[k] >= 3 * prog[k] for k in compared), (prog, other)
