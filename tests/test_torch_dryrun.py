"""The port's dry run of the three multi-device engines
(``rmf_crowdsim_tpu_torch/dryrun.py``, the counterpart of
``__graft_entry__.dryrun_multichip``) at D = 8 on the CPU, in-process and
as the command ``python -m rmf_crowdsim_tpu_torch.dryrun 8 --device cpu``.
"""

import os
import subprocess
import sys

import pytest
import torch

from rmf_crowdsim_tpu_torch.dryrun import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_three_modes(capsys):
    out = dryrun(8, "cpu")
    # Mode 1: the flagship crowd of 64 in 128 slots; no spawn at dt = 1/60.
    assert out["agent_sharded"]["alive"] == 64
    assert out["domain_sharded"]["alive"] == 128
    assert out["domain_sharded"]["max_tile_occupancy"] >= 1
    # Mode 3: two sources spawn one agent a step each, for 12 steps.
    w = out["world_sharded"]
    assert w["alive"] == 24 and w["migrated"] > 0
    assert w["arrival_dropped"] == 0 and w["stray"] == 0
    text = capsys.readouterr().out
    assert text.count("dryrun[") == 3 and text.count(", ok") == 2


def test_dryrun_command():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "rmf_crowdsim_tpu_torch.dryrun", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "4-shard 12-step rollout" in r.stdout
