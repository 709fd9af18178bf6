"""The control: the reference computed in bfloat16, the precision below
the float32 the configurations state, put in the program's place, fails
the cell's limits; run at the cells' own sizes on the card by
``python3 -m benchmark.calibrate``."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import CELLS, run


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails(workload):
    rec, out = run(workload, seconds=0.5)
    assert out["correct"]
    v = rec["driver"].control(1, torch.bfloat16)
    lim = harness.limits(workload)
    assert v.agents_off > lim["agents_off"] or v.events_off > \
        lim["events_off"]
    assert v.agents_off > 0.5 * v.compared
