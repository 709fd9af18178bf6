"""The port's Zanlungo math and force kernel against the JAX package.

Oracle math (``models/local.py``) to 1e-5; K1's plain version (the path
CPU tensors take through ``zanlungo_forces_bucketed``) against the JAX
Pallas kernel in interpret mode to 2e-4 on live slots, the tolerance of
every kernel-vs-oracle test in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.models import local as jlocal
from rmf_crowdsim_tpu.ops import neighbors as jnbr
from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch.models import local as tlocal
from rmf_crowdsim_tpu_torch.ops import neighbors as tnbr
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.utils.convert import zanlungo_params_from_numpy

PARAMS = dict(agent_scale=1.3, obstacle_scale=1.0, reaction_time=0.0,
              force_distance=4.0, agent_mass=2.0, agent_radius=0.4,
              force_cap=1e15)


def jax_params():
    return jlocal.ZanlungoParams(**{k: jnp.asarray(v, jnp.float32)
                                    for k, v in PARAMS.items()})


def torch_params():
    return zanlungo_params_from_numpy(
        {k: np.float32(v) for k, v in PARAMS.items()}, device="cpu")


def random_scene(seed, n, world, eyesight_max):
    """tests/test_zanlungo_pallas.py:31's scene, as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    pos = rng.uniform(0.0, world, (n, 2)).astype(f)
    vel = rng.uniform(-2, 2, (n, 2)).astype(f)
    pref_committed = rng.uniform(-2, 2, (n, 2)).astype(f)
    self_pref = rng.uniform(-2, 2, (n, 2)).astype(f)
    prio = rng.permutation(n).astype(f)
    eye = rng.uniform(0.5, eyesight_max, (n,)).astype(f)
    alive = rng.random(n) > 0.15
    rec = rng.uniform(-2, 2, (n, 2)).astype(f)
    return pos, vel, self_pref, pref_committed, prio, eye, alive, rec


def test_time_to_collision_matches_jax():
    rng = np.random.default_rng(0)
    n = 4000
    rel_vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    rel_pos = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    rel_vel[:50] = 0.0                      # a == 0 -> inf
    rel_pos[50:100] *= 0.05                 # overlapping -> 0
    want = np.asarray(jlocal.time_to_collision(
        jnp.asarray(rel_vel), jnp.asarray(rel_pos), jnp.float32(0.4)))
    got = tlocal.time_to_collision(
        torch.as_tensor(rel_vel), torch.as_tensor(rel_pos),
        torch.tensor(0.4, dtype=torch.float32)).numpy()
    assert np.isinf(want).any() and (want == 0).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_zanlungo_from_rows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    q, k = 64, 24
    f = np.float32

    def u(*shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(f)

    rows = dict(
        q_position=u(q, 2, lo=0, hi=6), q_velocity=u(q, 2),
        self_pref=u(q, 2), q_priority=rng.integers(0, 9, q).astype(f),
        opos=u(q, k, 2, lo=0, hi=6), ovel=u(q, k, 2), opref=u(q, k, 2),
        oprio=rng.uniform(0, 9, (q, k)).astype(f),
        nbr_valid=rng.random((q, k)) > 0.3, rec_vel=u(q, 2),
    )
    rows["opref"][:, :4] = 0.0              # stationary candidates
    want = np.asarray(jlocal.zanlungo_from_rows(
        jax_params(), *(jnp.asarray(v) for v in rows.values())))
    got = tlocal.zanlungo_from_rows(
        torch_params(), *(torch.as_tensor(v) for v in rows.values())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 2])
def test_brute_zanlungo_velocity_matches_jax(seed):
    scene = random_scene(seed, 96, 24.0, 3.0)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    jn = jnbr.brute_neighbors(jnp.asarray(pos), jnp.asarray(eye),
                              jnp.asarray(alive))
    want = np.asarray(jlocal.zanlungo_velocity(
        jax_params(), *(jnp.asarray(x) for x in
                        (pos, vel, self_pref, pref_c, prio)),
        jn.idx, jn.valid, jnp.asarray(rec)))
    tn = tnbr.brute_neighbors(torch.as_tensor(pos), torch.as_tensor(eye),
                              torch.as_tensor(alive))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    got = tlocal.zanlungo_velocity(
        torch_params(), *(torch.as_tensor(x) for x in
                          (pos, vel, self_pref, pref_c, prio)),
        tn.idx, tn.valid, torch.as_tensor(rec)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int_prio", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_force_kernel_plain_matches_jax_kernel(seed, int_prio):
    """K1's plain version against ``zanlungo_forces_bucketed`` in
    interpret mode, on the same packed planes, live slots only (the TPU
    kernel leaves garbage in empty sub-blocks)."""
    cfg_args = dict(width=24.0, height=24.0, offset=(0.0, 0.0),
                    max_eyesight=3.0, bucket=16, strip_tiles=6, sub_tiles=6)
    jcfg = jzp.BucketConfig.create(**cfg_args)
    tcfg = tzb.BucketConfig.create(**cfg_args)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = random_scene(
        seed, 96, 24.0, 3.0)
    packed_t, packed_T, _, occ, _ = jzp.bucketize(
        jcfg, *(jnp.asarray(x) for x in
                (pos, vel, pref_c, self_pref, prio, eye, rec, alive)))
    assert int(occ) <= jcfg.bucket
    want = np.asarray(jzp.zanlungo_forces_bucketed(
        jcfg, jzp.zparams5(jax_params()), packed_t, interpret=True,
        int_prio=int_prio, packed_T=packed_T))
    zp5 = tzb.zparams5(torch_params())
    np.testing.assert_array_equal(zp5.numpy(),
                                  np.asarray(jzp.zparams5(jax_params())))
    got = tzb.zanlungo_forces_bucketed(
        tcfg, zp5, torch.tensor(np.asarray(packed_t)),
        torch.tensor(np.asarray(packed_T)), int_prio=int_prio).numpy()
    live = np.asarray(packed_T)[tzb.ROW_ID] >= 0
    assert live.sum() == alive.sum()
    forced = np.abs(want[live] - np.asarray(packed_t)[live, 8:10]).sum(1)
    assert (forced > 0).sum() > 10  # real pair forces, not just rec
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("int_prio", [True, False])
def test_zanlungo_fused_matches_brute_oracle(int_prio):
    """The port's fused pass (bucketize -> K1 -> gather) against its own
    brute oracle, the pattern of test_fused_matches_oracle."""
    cfg = tzb.BucketConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, bucket=16,
                                  strip_tiles=6, sub_tiles=6)
    scene = [torch.as_tensor(x) for x in random_scene(3, 96, 24.0, 3.0)]
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    zp = torch_params()
    got, occ, dropped = tzb.zanlungo_fused(
        cfg, zp, pos, vel, self_pref, pref_c, prio, eye, alive, rec,
        use_pack_kernel=True, int_prio=int_prio)
    assert int(occ) <= cfg.bucket and int(dropped) == 0
    nb = tnbr.brute_neighbors(pos, eye, alive)
    want = tlocal.zanlungo_velocity(zp, pos, vel, self_pref, pref_c, prio,
                                    nb.idx, nb.valid, rec)
    a = alive.numpy()
    np.testing.assert_allclose(got.numpy()[a], want.numpy()[a], rtol=2e-4,
                               atol=2e-4)
