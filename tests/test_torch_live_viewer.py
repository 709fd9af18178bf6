"""The port's live viewer (``rmf_crowdsim_tpu_torch/examples/
live_viewer.py``) headless on the CPU: a 2 s run with ``--gif`` writes a
GIF that PIL reads back with more than one frame, and the agents stay
finite.  The viewer steps by wall-clock dt, so there is no trajectory to
hold against the JAX package; its interactive window (with a
``$DISPLAY``) is not tested.
"""

import math

import pytest
import torch
from PIL import Image

from rmf_crowdsim_tpu_torch.examples import live_viewer


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_headless_run_writes_a_gif(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    gif = tmp_path / "live.gif"
    # --lim 150: the three agents start at |x|, |y| = 60-100, outside the
    # default view.
    sim = live_viewer.main(["--seconds", "2", "--gif", str(gif), "--lim",
                            "150", "--device", "cpu"])
    assert f"wrote {gif}" in capsys.readouterr().out
    with Image.open(gif) as im:
        assert im.n_frames > 1
    assert sim.num_agents == 3 and sim.sim_time > 0
    for agent in sim.agents.values():
        assert all(math.isfinite(c) for c in agent.position)
