"""A run with the timed path broken underneath comes out not correct:
once for each fault the cells can have (``benchmark/faults.py``)."""

import pytest

from benchmark import faults
from benchmark.tests.tiny import CELLS, run


@pytest.mark.parametrize("fault", sorted(faults.STEP_FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    faults.STEP_FAULTS[fault](monkeypatch.setattr)
    _, out = run(workload)
    assert not out["correct"], out["checks"]


def test_altered_event_is_not_correct(monkeypatch):
    faults.event(monkeypatch.setattr)
    _, out = run("rmf_hall.session")
    assert not out["correct"]
    assert out["checks"]["events_off"]["value"] > 0
