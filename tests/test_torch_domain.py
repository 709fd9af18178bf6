"""The domain-decomposed force pass (parallel/domain.py) and ``col_clip``
binning, on the CPU.

- ``bucketize(col_clip=...)`` against the JAX package's, with a clip that
  moves agents of four columns into the two columns inside it: bucket
  slots and counts bitwise, the packed planes bitwise on live slots.
- ``zanlungo_fused_domain`` at D = 8 against the port's single-shard
  ``zanlungo_fused`` (1e-5) and against JAX's ``zanlungo_fused_domain``
  on the 8-virtual-device mesh, its kernel in interpret mode (2e-4), on
  the scene of tests/test_domain.py:15-37 (numpy seeds 0 and 1).
- ``build_step(world_mesh=...)``: the full step with the force pass
  domain-decomposed against the single-device step (1e-6), on the scene
  of tests/test_domain.py:40-83; ``grid_dense`` refuses a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu.parallel.domain import WORLD_AXIS
from rmf_crowdsim_tpu.parallel.domain import (
    zanlungo_fused_domain as jax_fused_domain,
)
from rmf_crowdsim_tpu_torch import (
    GridConfig,
    ParityVelocity,
    SimConfig,
    Zanlungo,
    build_step,
    make_state,
)
from rmf_crowdsim_tpu_torch.core.step import SimParams
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.parallel.comm import make_thread_mesh
from rmf_crowdsim_tpu_torch.parallel.domain import zanlungo_fused_domain
from rmf_crowdsim_tpu_torch.utils.convert import zanlungo_params_from_numpy
from tests.test_zanlungo_pallas import make_params, random_scene

TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(world=48.0):
    kw = dict(bucket=16, strip_tiles=6, sub_tiles=6)
    return (jzp.BucketConfig.create(world, world, (0.0, 0.0), 3.0, **kw),
            tzb.BucketConfig.create(world, world, (0.0, 0.0), 3.0, **kw))


def _torch_scene(scene):
    return [torch.as_tensor(np.array(a)) for a in scene]


def test_bucketize_col_clip_matches_jax():
    jcfg, tcfg = _cfgs()
    assert tcfg.tx == 16
    clip = (2, 13)
    scene = random_scene(3, 160, 48.0, 3.0)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    jp_t, _, jbpos, jocc, jdrop = jzp.bucketize(
        jcfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive,
        col_clip=clip)
    t = _torch_scene(scene)
    tp_t, tp_T, tbpos, tocc, tdrop = tzb.bucketize(
        tcfg, t[0], t[1], t[3], t[2], t[4], t[5], t[7], t[6],
        col_clip=clip)
    np.testing.assert_array_equal(tbpos.numpy(), np.asarray(jbpos))
    assert int(tocc) == int(jocc) and int(tdrop) == int(jdrop)
    # The clip really moved agents: some bin outside their own column.
    col = np.floor(np.asarray(pos)[:, 0] / tcfg.tile_size)
    moved = np.asarray(alive) & ((col < clip[0]) | (col > clip[1]))
    assert moved.sum() > 10
    live = np.asarray(jp_t)[:, tzb.ROW_ID] >= 0
    assert live.sum() > 100
    np.testing.assert_array_equal(tp_t.numpy()[live], np.asarray(jp_t)[live])
    np.testing.assert_array_equal((tp_t[:, tzb.ROW_ID] >= 0).numpy(), live)
    assert torch.equal(tp_T, tp_t[:, :tzb.NUM_CAND].t())
    # No slot outside the clipped columns is used.
    used_cols = np.unique(tbpos.numpy()[tbpos.numpy() < tcfg.slots]
                          // (tcfg.ty * tcfg.bucket))
    assert used_cols.min() >= clip[0] and used_cols.max() <= clip[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_domain_sharded_matches_single_and_jax(seed):
    jcfg, tcfg = _cfgs()
    zp = make_params()
    scene = random_scene(seed, 128, 48.0, 3.0)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), (WORLD_AXIS,))
    want, _, _ = jax.jit(lambda *a: jax_fused_domain(
        mesh, jcfg, zp, *a, interpret=True))(*scene)

    t = _torch_scene(scene)
    tzp = zanlungo_params_from_numpy(jax.tree.map(np.asarray, zp), "cpu")
    got, occ, dropped = zanlungo_fused_domain(
        make_thread_mesh(8, "cpu"), tcfg, tzp, *t)
    single, occ1, dropped1 = tzb.zanlungo_fused(tcfg, tzp, *t)
    a = t[6]
    assert int(occ) == int(occ1) and int(dropped) == int(dropped1) == 0
    torch.testing.assert_close(got[a], single[a], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[a].numpy(), np.asarray(want)[a.numpy()],
                               rtol=TOL, atol=TOL)


def _step_scene(backend="grid_pallas"):
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(width=48.0, height=48.0, cell_size=3.0,
                        offset=(0.0, 0.0)),
        neighbor_backend=backend, max_eyesight=3.0, bucket_capacity=16,
        strip_tiles=6, sub_tiles=6, dtype="float32")
    hl = ParityVelocity((1.0, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 2.0, 2.0, 0.3)
    pos = np.random.default_rng(1).uniform(2.0, 46.0, (64, 2))
    f = torch.float32
    state = make_state(cfg, device="cpu").replace(
        position=torch.as_tensor(pos, dtype=f),
        eyesight=torch.full((64,), 3.0, dtype=f),
        alive=torch.ones((64,), dtype=torch.bool),
        uid=torch.arange(64, dtype=torch.int32),
        hl_idx=torch.zeros((64,), dtype=torch.int32),
        lp_idx=torch.zeros((64,), dtype=torch.int32),
        priority=torch.arange(64, dtype=f),
        next_uid=torch.tensor(64, dtype=torch.int32))
    params = SimParams(hl=(hl.init_params("cpu"),),
                       lp=(lp.init_params("cpu"),), sources=None)
    return cfg, hl, lp, params, state


@pytest.mark.parametrize("d", [3, 8])
def test_full_step_with_domain_mesh_matches_single(d):
    """D = 3 rounds tx = 16 up to 18 columns (core/step.py:444-451)."""
    cfg, hl, lp, params, state = _step_scene()
    s1, e1 = build_step(cfg, [hl], [lp])(params, state, 0.1)
    mesh = make_thread_mesh(d, "cpu")
    s2, e2 = build_step(cfg, [hl], [lp], world_mesh=mesh)(params, state,
                                                          0.1)
    torch.testing.assert_close(s2.position, s1.position, rtol=1e-6,
                               atol=1e-6)
    assert int(e2.neighbor_truncated) == 0
    moved = (s2.position - state.position - 0.1 * torch.tensor([1.0, 0.0]))
    assert moved.abs().max() > 1e-4  # forces acted


def test_grid_dense_refuses_a_world_mesh():
    cfg, hl, lp, _, _ = _step_scene("grid_dense")
    with pytest.raises(ValueError, match="single-device"):
        build_step(cfg, [hl], [lp], world_mesh=make_thread_mesh(2, "cpu"))
