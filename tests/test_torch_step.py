"""The whole slice: the port's rollout against the JAX package's.

The 1,024-agent bench scene with a 48-agent hotspot inside one tile (so
buckets overflow and the spill path runs), 3 steps at dt = 1/60, through
JAX ``build_rollout`` (``grid_pallas`` with the Pallas kernels in
interpret mode, and ``brute``) and through the port's ``build_rollout``
on CPU tensors, from the same state carried across by
``utils/convert.py``.  Positions are compared by uid (the presort is an
unstable sort) to 2e-4; the counters must be equal.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
from rmf_crowdsim_tpu.core.step import build_rollout as jax_build_rollout
from rmf_crowdsim_tpu_torch import ParityVelocity, Zanlungo, scenes
from rmf_crowdsim_tpu_torch.core.state import STATE_TENSOR_FIELDS
from rmf_crowdsim_tpu_torch.core.step import SimParams, build_rollout
from rmf_crowdsim_tpu_torch.ops import pack, spill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as tzd
from rmf_crowdsim_tpu_torch.utils import convert, cuda_build

N = 1024
STEPS = 3
DT = 1.0 / 60.0
HOTSPOT = (6.0, 6.0)   # inside tile (5, 5) of the 1,024-agent world
KERNELS = (pack.pack_rows, tzb.zanlungo_forces_bucketed, spill.spill_window,
           tzb.zanlungo_forces_bucketed_spill, tzd.zanlungo_forces_dense)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_config(backend, **kw):
    """The port's bench config (``kw``: more ``bench_config`` options),
    read field for field into the JAX package's SimConfig (one scene
    spec, two packages)."""
    c = scenes.bench_config(N, backend=backend, **kw)
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    fields["grid"] = J.GridConfig(**dataclasses.asdict(c.grid))
    fields["pallas_interpret"] = True
    return J.SimConfig(**fields)


def jax_bench(backend, **kw):
    config = jax_config(backend, **kw)
    hl = J.ParityVelocity((1.0, 0.0))
    lp = J.Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                    force_distance=1.0, agent_mass=2.0, agent_radius=0.25,
                    force_cap=20.0)
    pos = scenes.bench_positions(N, config.grid.width, hotspot=True,
                                 hotspot_origin=HOTSPOT)
    f = jnp.float32
    state = J.make_state(config).replace(
        position=jnp.asarray(pos, f),
        eyesight=jnp.full((N,), 2.0, f),
        alive=jnp.ones((N,), jnp.bool_),
        uid=jnp.arange(N, dtype=jnp.int32),
        hl_idx=jnp.zeros((N,), jnp.int32),
        lp_idx=jnp.zeros((N,), jnp.int32),
        priority=jnp.arange(N, dtype=f),
        next_uid=jnp.asarray(N, jnp.int32),
    )
    params = J.SimParams(hl=(hl.init_params(),), lp=(lp.init_params(),),
                         sources=None)
    return jax_build_rollout(config, [hl], [lp]), params, state


def by_uid(position, uid):
    return np.asarray(position)[np.argsort(np.asarray(uid))]


def port_inputs(params, state):
    """The JAX bench's state and parameters, carried across as numpy."""
    t_state = convert.state_from_numpy(jax.tree.map(np.asarray, state),
                                       device="cpu")
    t_params = SimParams(
        hl=(convert.hl_params_from_numpy(
            jax.tree.map(np.asarray, params.hl[0]), device="cpu"),),
        lp=(convert.zanlungo_params_from_numpy(
            jax.tree.map(np.asarray, params.lp[0]), device="cpu"),),
    )
    return t_params, t_state


@pytest.fixture(scope="module")
def runs():
    out = {}
    for backend in ("grid_pallas", "brute"):
        rollout, params, state = jax_bench(backend)
        st, c = jax.jit(rollout, static_argnums=(3,))(params, state, DT,
                                                      STEPS)
        out["jax_" + backend] = (by_uid(st.position, st.uid),
                                 jax.tree.map(np.asarray, c))

        # The port starts from the JAX state and parameters.
        t_params, t_state = port_inputs(params, state)
        t_config = scenes.bench_config(N, backend=backend)
        t_rollout = build_rollout(
            t_config, [ParityVelocity((1.0, 0.0))],
            [Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)])
        for k in KERNELS:
            k.launches = 0
        st, c = t_rollout(t_params, t_state, DT, STEPS)
        out["launches_" + backend] = [k.launches for k in KERNELS]
        out["torch_" + backend] = (by_uid(st.position, st.uid), c)
    return out


@pytest.mark.parametrize("port,ref", [
    ("grid_pallas", "grid_pallas"),
    ("grid_pallas", "brute"),
    ("brute", "brute"),
])
def test_rollout_positions_match_jax_by_uid(runs, port, ref):
    got = runs["torch_" + port][0]
    want = runs["jax_" + ref][0]
    assert np.isfinite(got).all() and got.shape == (N, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backend", ["grid_pallas", "brute"])
def test_rollout_counters_match_jax(runs, backend):
    got = runs["torch_" + backend][1]
    want = runs["jax_" + backend][1]
    for name in ("n_alive", "max_cell_occupancy", "neighbor_truncated",
                 "n_spawned", "n_destroyed", "out_of_bounds"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert (got.neighbor_truncated.numpy() == 0).all()
    assert (got.n_alive.numpy() == N).all()
    if backend == "grid_pallas":
        # The hotspot overflows a bucket: the spill path ran.
        assert (got.max_cell_occupancy.numpy()
                > scenes.bench_config(N).bucket_capacity).all()


def test_launch_counters_stay_zero_on_cpu(runs):
    """CPU tensors take the kernels' plain versions and launch nothing."""
    assert runs["launches_grid_pallas"] == [0] * len(KERNELS)
    assert runs["launches_brute"] == [0] * len(KERNELS)


def test_converter_round_trip():
    _, params, state = jax_bench("grid_pallas")
    arrays = jax.tree.map(np.asarray, state)
    t_state = convert.state_from_numpy(arrays, device="cpu")
    back = convert.state_to_numpy(t_state)
    assert set(back) == set(STATE_TENSOR_FIELDS)
    for name in STATE_TENSOR_FIELDS:
        np.testing.assert_array_equal(back[name], getattr(arrays, name),
                                      err_msg=name)
        assert back[name].dtype == getattr(arrays, name).dtype, name
    # The port's own scene builder gives the same state.
    _, _, own = scenes.build_bench(N, device="cpu", hotspot=True,
                                   hotspot_origin=HOTSPOT)
    for name in STATE_TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      back[name], err_msg=name)
    zp = convert.zanlungo_params_from_numpy(
        jax.tree.map(np.asarray, params.lp[0]), device="cpu")
    assert float(zp.force_cap) == 20.0 and float(zp.agent_mass) == 2.0
    hl = convert.hl_params_from_numpy(jax.tree.map(np.asarray, params.hl[0]),
                                      device="cpu")
    np.testing.assert_array_equal(hl["vel"].numpy(), [1.0, 0.0])


def test_skin_reuses_the_carried_binning():
    """In the uniform bench scene agents stay inside the skin margin: only
    the first step sorts, the next two reuse the carried binning
    (core/step.py:582), and the physics equals re-sorting every step."""
    from rmf_crowdsim_tpu_torch.core.step import build_step

    config = scenes.bench_config(N)
    planners = ([ParityVelocity((1.0, 0.0))],
                [Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)])
    _, params, state = scenes.build_bench(N, device="cpu")
    skin_step = build_step(config, *planners, skin_mode=True)
    plain_step = build_step(config, *planners)
    assert skin_step.skin_mode and not plain_step.skin_mode
    skin = dict(valid=torch.zeros((), dtype=torch.bool),
                key=torch.zeros(N, dtype=torch.int32),
                bpos=torch.zeros(N, dtype=torch.int32),
                max_occ=torch.zeros((), dtype=torch.int32),
                n_over=torch.zeros((), dtype=torch.int32),
                ref=torch.zeros(N, 2), resorted=False)
    resorted = []
    carried, fresh = state, state
    for _ in range(3):
        carried, ev, skin = skin_step(params, carried, DT, skin)
        fresh, _ = plain_step(params, fresh, DT)
        resorted.append(skin["resorted"])
        assert int(ev.neighbor_truncated) == 0
    assert resorted == [True, False, False]
    np.testing.assert_allclose(by_uid(carried.position, carried.uid),
                               by_uid(fresh.position, fresh.uid),
                               rtol=2e-4, atol=2e-4)


def test_unported_paths_raise():
    """The paths that raised before they were ported — the ``grid`` and
    ``custom`` backends, SourceSink tables and per-uid event streams —
    now build and step on CPU tensors; what still raises is the
    ``custom`` backend without a ``neighbor_fn`` (a ``ValueError``, as in
    the JAX package)."""
    from rmf_crowdsim_tpu_torch.core.step import build_step
    from rmf_crowdsim_tpu_torch.ops.neighbors import brute_neighbors

    def neighbor_fn(st):
        return brute_neighbors(st.position, st.eyesight, st.alive)

    planners = ([ParityVelocity((1.0, 0.0))],
                [Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25)])
    _, params, state = scenes.build_bench(N, device="cpu")
    for backend, fn in (("grid", None), ("custom", neighbor_fn)):
        st, ev = build_step(scenes.bench_config(N, backend=backend),
                            *planners, neighbor_fn=fn)(params, state, DT)
        assert int(ev.neighbor_truncated) == 0
        assert bool(torch.isfinite(st.position).all())
    with pytest.raises(ValueError, match="neighbor_fn"):
        build_step(scenes.bench_config(N, backend="custom"), *planners)
    rollout, params, state = scenes.build_streams(
        N, N + 64, 4, device="cpu", event_capacity=16)
    st, rec = rollout(params, state, DT, 2)
    assert rec.spawned_uid.shape == (2, 16)
    assert int(rec.counters.n_spawned.sum()) > 0
    assert int(st.num_alive) == N + int(rec.counters.n_spawned.sum())


def test_kernel_wrappers_refuse_cpu_tensors_for_launch():
    """The launch path checks device, dtype and shape and raises; it is
    reached only with CUDA tensors."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_build.check_tensors("pack_rows", feat_t=(
            torch.zeros(16, 4), torch.float32, (16, 4)))


def test_import_leaves_jax_out():
    """The port never imports JAX, flax or the JAX package: every module
    of the package (walked, so that no new one is missed), the probes
    among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rmf_crowdsim_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'rmf_crowdsim_tpu_torch.probes.k1_stages', "
        "'rmf_crowdsim_tpu_torch.probes.mma_chain', "
        "'rmf_crowdsim_tpu_torch.probes.planes', "
        "'rmf_crowdsim_tpu_torch.utils.profile_step'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'rmf_crowdsim_tpu')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
