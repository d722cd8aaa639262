# -*- coding: utf-8 -*-
"""The control reads not correct against every cell's limits.

The control is the plain reference put in the program's place at the
precision below the one the configuration states (TF32 products in the
frontend and the net, the frontend's outputs and the detector's arrays in
bfloat16, a bfloat16 search, float32 cue arithmetic); on the card it is
read at each cell's own size by ``benchmark/readings.py``. Here it runs at
one minute a film on the CPU, on the syncs of a short run."""
import pytest

from benchmark.harness import spec
from benchmark.readings import readings
from benchmark.tests.conftest import tiny

CELLS = ["film90-default", "film90-fused", "season10-default"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_incorrect(cell, cpu_program):
    out = readings(cell, [2**31 + 3], {2**31 + 3}, 2, require_cuda=False,
                   overrides=tiny(cell), log=lambda _line: None)
    row = out[2**31 + 3]
    limits = spec.workload(cell)["limits"]
    failed = [k for k, limit in limits.items() if row["control"][k] > limit]
    assert failed, (row["control"], limits)
