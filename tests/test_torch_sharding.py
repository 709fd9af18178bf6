"""The agent-sharded engine (parallel/sharding.py) on the CPU, on the
scene of tests/test_sharding.py:30-67 (64 slots, 32 agents, the grid
backend, one SourceSink): the step at D = 8 against the port's
single-device step (rtol = atol = 1e-6, ``alive`` and ``spawned`` equal)
and against JAX's ``build_sharded_step`` on its 8-device mesh (2e-4); the
rollout at D = 8 against the single-device rollout.
"""

import jax
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.parallel.sharding import (
    build_sharded_step as jax_sharded_step,
)
from rmf_crowdsim_tpu.parallel.sharding import make_mesh as jax_make_mesh
from rmf_crowdsim_tpu.parallel.sharding import (
    replicate_params as jax_replicate_params,
)
from rmf_crowdsim_tpu.parallel.sharding import shard_state as jax_shard_state
from rmf_crowdsim_tpu_torch import (
    GridConfig,
    MonotonicCrowd,
    ParityVelocity,
    SimConfig,
    SourceSink,
    Zanlungo,
    build_rollout,
    build_step,
)
from rmf_crowdsim_tpu_torch.core.state import STATE_TENSOR_FIELDS
from rmf_crowdsim_tpu_torch.core.step import SimParams
from rmf_crowdsim_tpu_torch.models.source_sink import stack_source_params
from rmf_crowdsim_tpu_torch.parallel.sharding import (
    build_sharded_rollout,
    build_sharded_step,
    gather_shards,
    make_mesh,
    replicate_params,
    shard_state,
)
from rmf_crowdsim_tpu_torch.utils.convert import state_from_numpy
from tests.test_sharding import scene as jax_scene

TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_scene():
    """tests/test_sharding.py's scene in the port, its state carried
    across from the JAX one."""
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(width=64.0, height=64.0, cell_size=4.0,
                        offset=(-32.0, -32.0)),
        neighbor_backend="grid", max_per_cell=64, max_eyesight=4.0,
        dtype="float32")
    hl = ParityVelocity((1.0, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 2.0, 2.0, 0.25)
    src = SourceSink(source=(-30.0, 0.0), waypoints=[(30.0, 0.0)],
                     radius_sink=1.0, crowd_generator=MonotonicCrowd(1.0),
                     high_level_planner=hl, local_planner=lp,
                     agent_eyesight_range=4.0)
    params = SimParams(
        hl=(hl.init_params("cpu"),), lp=(lp.init_params("cpu"),),
        sources=stack_source_params([src], [0], [0], [[-1]], cfg.tdtype,
                                    device="cpu"))
    jstate = jax_scene()[4]
    state = state_from_numpy({k: np.asarray(getattr(jstate, k))
                              for k in STATE_TENSOR_FIELDS}, device="cpu")
    return cfg, hl, lp, params, state


def test_sharded_step_matches_single_and_jax():
    cfg, hl, lp, params, state = port_scene()
    s1, e1 = build_step(cfg, [hl], [lp])(params, state, 0.1)
    mesh = make_mesh(8, "cpu")
    shards, events = build_sharded_step(cfg, [hl], [lp], mesh)(
        replicate_params(mesh, params), shard_state(mesh, state), 0.1)
    assert len(shards) == 8 and all(s.capacity == 8 for s in shards)
    s2, e2 = gather_shards(shards), gather_shards(events)
    torch.testing.assert_close(s2.position, s1.position, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(s2.alive, s1.alive)
    assert torch.equal(e2.spawned, e1.spawned)

    jcfg, jhl, jlp, jparams, jstate = jax_scene()
    jmesh = jax_make_mesh(8)
    js, je = jax_sharded_step(jcfg, [jhl], [jlp], jmesh)(
        jax_replicate_params(jmesh, jparams), jax_shard_state(jmesh, jstate),
        0.1)
    np.testing.assert_allclose(s2.position.numpy(), np.asarray(js.position),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(s2.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(e2.spawned.numpy(),
                                  np.asarray(je.spawned))


def test_sharded_rollout_matches_single():
    cfg, hl, lp, params, state = port_scene()
    mesh = make_mesh(8, "cpu")
    shards, c = build_sharded_rollout(cfg, [hl], [lp], mesh)(
        params, shard_state(mesh, state), 0.1, 5)
    assert c.n_alive.shape == (5,) and int(c.n_alive[-1]) >= 32
    st1, c1 = build_rollout(cfg, [hl], [lp])(params, state, 0.1, 5)
    st = gather_shards(shards)
    torch.testing.assert_close(st.position, st1.position, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(st.alive, st1.alive)
    assert torch.equal(c.n_alive, c1.n_alive)
