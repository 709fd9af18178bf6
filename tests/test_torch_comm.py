"""The mesh of the multi-device engines (parallel/comm.py) on the CPU.

``ThreadComm``: every collective at D = 1, 2, 4 and 8, the edge shards
receiving zeros; a shard that raises makes the run raise that error
within the barrier timeout, and a shard that never reaches a collective
makes its peers raise at the timeout, not hang.  ``ProcessGroupComm``
over gloo in 2 and 4 spawned processes: the same collectives, the same
results.
"""

import threading
import time

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch.parallel.comm import make_thread_mesh
from tests.torch_multidevice import exercise, expected, run_process_group


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(results, d):
    assert len(results) == d
    for r, got in enumerate(results):
        want = expected(r, d)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("turns", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_thread_comm_collectives(d, turns):
    """``turns``: whether the shards take turns between collectives, as
    they do on a card (forced here on the CPU)."""
    mesh = make_thread_mesh(d, "cpu")
    mesh.turns = turns
    assert mesh.local_ranks == tuple(range(d))
    _check(mesh.run(exercise), d)
    # Runs take per-shard arguments, one entry a shard.
    assert mesh.run(lambda comm, a: (comm.axis_index(), a),
                    list("abcdefgh"[:d])) == list(enumerate("abcdefgh"[:d]))


@pytest.mark.parametrize("turns", [False, True])
def test_thread_comm_many_collectives_in_a_row(turns):
    """Shards that run ahead to the next collective never overwrite what a
    slower peer has yet to read (the two tables alternate)."""
    mesh = make_thread_mesh(4, "cpu")
    mesh.turns = turns

    def body(comm):
        r = comm.axis_index()
        out = []
        for k in range(200):
            if (k + r) % 7 == 0:
                time.sleep(0.001)
            out.append(int(comm.psum(torch.tensor(k * (r + 1)))))
        return out

    want = [k * 10 for k in range(200)]
    assert mesh.run(body) == [want] * 4


@pytest.mark.parametrize("turns", [False, True])
def test_thread_comm_shard_error_raises_not_hangs(turns):
    mesh = make_thread_mesh(4, "cpu", timeout=60.0)
    mesh.turns = turns

    def body(comm):
        if comm.axis_index() == 2:
            raise ValueError("shard 2 failed")
        comm.psum(torch.tensor(1))
        return comm.psum(torch.tensor(2))

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 2 failed"):
        mesh.run(body)
    assert time.monotonic() - t0 < 30.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shard-") and t.is_alive()]


@pytest.mark.parametrize("turns", [False, True])
def test_thread_comm_missing_peer_times_out(turns):
    mesh = make_thread_mesh(3, "cpu", timeout=1.0)
    mesh.turns = turns

    def body(comm):
        if comm.axis_index() == 0:
            return None  # never reaches the collective
        return comm.psum(torch.tensor(1))

    t0 = time.monotonic()
    with pytest.raises(threading.BrokenBarrierError):
        mesh.run(body)
    assert time.monotonic() - t0 < 20.0


@pytest.mark.parametrize("d", [2, 4])
def test_process_group_comm_collectives(d, tmp_path):
    _check(run_process_group(d, tmp_path, exercise), d)
