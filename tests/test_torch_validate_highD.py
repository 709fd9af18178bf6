"""The port's high-D validation tool (``rmf_crowdsim_tpu_torch/tools/
validate_highD.py``) on the CPU.

- ``validate(16, "cpu")``: the crossing scene over 16 shards of a
  ``ThreadMesh`` equals one shard bit for bit in bitwise mode, with
  migrations and none dropped, and within 1e-5 in tolerance mode with the
  lifecycle counters equal (~2 min: the 16 shard threads share one
  interpreter);
- a difference in either mode raises;
- ``halo_table()`` prints what the JAX tool's ``halo_table()`` prints
  (``tools/validate_highD.py``, loaded by path).
"""

import os
import runpy
import sys
import types

import jax
import pytest
import torch

from rmf_crowdsim_tpu_torch.tools import validate_highD as vhd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validate_d16_on_cpu(capsys):
    r = vhd.validate(16, "cpu")
    assert r["agents"] > 20 and r["migrations"] > 0
    assert r["tolerance_agents"] == r["agents"]
    assert r["tolerance_max_diff"] <= vhd.TOL
    assert 0 < r["resorted"] < r["shard_steps"] == 16 * vhd.N_STEPS
    out = capsys.readouterr().out
    assert f"bitwise 16-vs-1: EXACT over {r['agents']} agents" in out
    assert "tolerance 16-vs-1: allclose" in out


def _counters(migrated=3, dropped=0, alive=(1, 2)):
    t = torch.tensor
    return types.SimpleNamespace(
        migrated=t([migrated]), arrival_dropped=t([dropped]),
        n_alive=t(alive), n_spawned=t([1, 1]), n_destroyed=t([0, 0]),
        resorted=t([1, 0]))


@pytest.mark.parametrize("fault", ["bitwise", "tolerance", "lifecycle",
                                   "dropped"])
def test_validate_raises_on_a_difference(monkeypatch, fault):
    """``run_world`` replaced by canned results of 21 agents in which one
    thing differs between D and D = 1."""
    agents = {u: (1.0 * u, 2.0, 0.5, 0.0, 0) for u in range(21)}

    def run_world(d, device, invariance="bitwise", **kw):
        a, c = dict(agents), _counters()
        if d > 1 and fault == invariance:
            a[7] = (7.0 + 1e-3, 2.0, 0.5, 0.0, 0)
        if d > 1 and fault == "lifecycle" and invariance == "tolerance":
            c = _counters(alive=(1, 3))
        if d > 1 and fault == "dropped":
            c = _counters(dropped=1)
        return a, c

    monkeypatch.setattr(vhd, "run_world", run_world)
    with pytest.raises(AssertionError):
        vhd.validate(4, "cpu")


def test_halo_table_matches_the_jax_tool(capsys):
    """The JAX tool imports ``bench`` (which sets a JAX compilation cache
    directory) and puts the repo and ``tests/`` on ``sys.path``; both are
    put back after."""
    path = list(sys.path)
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        tool = runpy.run_path(os.path.join(REPO, "tools", "validate_highD.py"))
        tool["halo_table"]()
    finally:
        sys.path[:] = path
        sys.modules.pop("bench", None)
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          cache[1])
    want = capsys.readouterr().out
    rows = vhd.halo_table()
    got = capsys.readouterr().out
    assert got == want
    assert len(want.splitlines()) == 2 + len(vhd.TABLE_D) == 2 + len(rows)
    assert rows[3][:3] == (16, 240, 15)
