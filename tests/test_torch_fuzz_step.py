"""The randomized differential sweep of tests/test_fuzz_step.py on the port.

Three parts, all on the CPU, where every kernel wrapper runs its plain
version:

- the port against its own ``brute`` on the 43 cases of the JAX file
  (backends agree, seeds 0-4; bucket 32, seeds 0 and 2; the sweep on
  ``grid_pallas``, seeds 0-23, and on ``grid_dense``, seeds 0-11), with
  its assertions and tolerances: the same uids alive, positions by uid to
  2e-5 (``grid``) or 2e-4, the rollout counters equal under ``run()``,
  and one agent despawned every third ``step()``;
- the port's fast backend against the JAX package's ``brute`` on seeds
  0-7 of each sweep, after every step.  Sources that draw from
  ``PoissonCrowd`` are given a ``MonotonicCrowd`` of the same rate on both
  sides (``scenes.monotonic_sources``): the two packages draw Poisson
  counts from different generators by design;
- one test that ``scenes.fuzz_case`` and its fixed families draw the JAX
  file's cases seed for seed: the file is loaded by path, its
  ``Simulation`` replaced in the loaded module by a recorder, and its own
  tests and helpers run to record what they build and drive.

The wide cases of ``chip_smoke.py`` phase 10b are too large to step
here; the last test holds their geometry to what the phase needs.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as zd

FUZZ_FILE = pathlib.Path(__file__).with_name("test_fuzz_step.py")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (the suite's parallel workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(case):
    out = scenes.run_fuzz_case(case, device="cpu")
    assert out["steps"] == case.n_steps
    assert out["truncated"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_backends_agree_on_random_scenes(seed):
    _run(scenes.agree_case(seed))


@pytest.mark.parametrize("seed", [0, 2])
def test_big_tile_bucket32_matches(seed):
    _run(scenes.bucket32_case(seed))


@pytest.mark.parametrize("seed", list(range(24)))
def test_randomized_config_sweep(seed):
    _run(scenes.fuzz_case(seed))


@pytest.mark.parametrize("seed", list(range(12)))
def test_randomized_config_sweep_dense(seed):
    _run(scenes.fuzz_case(seed, "grid_dense"))


@pytest.mark.parametrize("backend", ["grid_pallas", "grid_dense"])
@pytest.mark.parametrize("seed", list(range(8)))
def test_port_matches_jax_brute(seed, backend):
    case = scenes.monotonic_sources(scenes.fuzz_case(seed, backend))
    ref = J.Simulation(scenes.fuzz_config(case, "brute", J), seed=case.seed)
    scenes.populate_fuzz_session(ref, case, J)
    sims = {"brute": ref,
            backend: scenes.build_fuzz_session(case, backend, "cpu")}
    out = scenes.drive_fuzz(case, sims)
    assert out["steps"] == case.n_steps


# ---- the port draws the JAX file's cases ----------------------------------


class _Recorder:
    """Stands in for ``Simulation``: records the config, seed, agents,
    sources and every call.  Its agents all stand at the origin, so the
    sweeps' comparisons pass and their churn draws its victims."""

    made = []

    def __init__(self, config, seed=0):
        self.config, self.seed = config, seed
        self.groups, self.sources, self.calls = [], [], []
        self.alive = []
        _Recorder.made.append(self)

    def add_agents(self, positions, hl, lp, agent_eyesight_range):
        pos = np.asarray(positions, np.float64)
        self.groups.append((pos, hl, lp, float(agent_eyesight_range)))
        start = sum(g[0].shape[0] for g in self.groups[:-1])
        self.alive += list(range(start, start + pos.shape[0]))

    def add_source_sink(self, ss):
        self.sources.append(ss)

    def step(self, dt):
        self.calls.append(("step", dt))

    def run(self, n_steps, dt):
        self.calls.append(("run", n_steps, dt))
        zeros = np.zeros((n_steps,), np.int32)
        return types.SimpleNamespace(
            **{f: zeros for f in scenes.FUZZ_RUN_COUNTERS})

    def remove_agents(self, agent_id):
        self.calls.append(("remove", agent_id))
        self.alive.remove(agent_id)

    @property
    def agents(self):
        return {u: types.SimpleNamespace(position=(0.0, 0.0))
                for u in self.alive}


def _jax_sweep_module():
    spec = importlib.util.spec_from_file_location("_jax_fuzz_step",
                                                  FUZZ_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.Simulation = _Recorder
    return mod


def _recorded(run):
    """The recorders that ``run()`` made, by backend."""
    _Recorder.made = []
    run()
    return {r.config.neighbor_backend: r for r in _Recorder.made}


def _same_draws(case, recs):
    """Every recorder holds ``case``: config, seed, agents, planners and
    sources."""
    assert sorted(recs) == sorted(("brute",) + tuple(case.fast)), case.name
    lp = J.Zanlungo(**case.lp)
    for backend, rec in recs.items():
        label = f"{case.name} {backend}"
        assert rec.config == scenes.fuzz_config(case, backend, J), label
        assert rec.seed == case.seed, label
        pos = np.concatenate([g[0] for g in rec.groups])
        eye = np.concatenate([np.full((g[0].shape[0],), g[3])
                              for g in rec.groups])
        np.testing.assert_array_equal(pos, case.positions, err_msg=label)
        np.testing.assert_array_equal(eye, case.eyesight, err_msg=label)
        hl, zan = rec.groups[0][1], rec.groups[0][2]
        assert hl._vel == tuple(case.hl_velocity), label
        assert zan._p == lp._p, label
        assert len(rec.sources) == len(case.sources), label
        for ss, spec in zip(rec.sources, case.sources):
            gen = {J.PoissonCrowd: "poisson", J.MonotonicCrowd: "monotonic"}[
                type(ss.crowd_generator)]
            got = scenes.SourceSpec(
                source=tuple(ss.source),
                waypoints=tuple(tuple(w) for w in ss.waypoints),
                radius_sink=ss.radius_sink, generator=gen,
                rate=ss.crowd_generator.rate,
                eyesight=ss.agent_eyesight_range,
                loop_forever=ss.loop_forever)
            assert got == spec, label
            assert ss.high_level_planner is hl, label
            assert ss.local_planner is zan, label


def test_fuzz_cases_are_the_jax_sweeps():
    """Each case builds what the JAX file builds, and ``drive_fuzz``
    makes the calls its test makes: the same ``step``/``run`` calls, dt
    and churn victims."""
    mod = _jax_sweep_module()
    cases = scenes.fuzz_cases()
    assert len(cases) == 43
    for case in cases:
        if case.name.startswith("backends_agree"):
            run = lambda: mod.test_backends_agree_on_random_scenes(case.seed)
        elif case.name.startswith("big_tile_bucket32"):
            run = lambda: mod.test_big_tile_bucket32_matches(case.seed)
        else:
            def run():
                fast = case.fast[0]
                mod._run_sweep(*mod._build_pair(case.seed, fast), fast)
        recs = _recorded(run)
        _same_draws(case, recs)
        ours = {}
        for backend in recs:
            ours[backend] = _Recorder(
                scenes.fuzz_config(case, backend, J), case.seed)
            scenes.populate_fuzz_session(ours[backend], case, J)
        scenes.drive_fuzz(case, ours)
        for backend, rec in recs.items():
            assert ours[backend].calls == rec.calls, (case.name, backend)
        assert any(c[0] == "remove" for c in rec.calls) == (
            case.churn and case.n_steps >= 3), case.name


# ---- the wide cases of phase 10b --------------------------------------------


def test_wide_cases_reach_the_kernel_geometry():
    """Phase 10b's cases: 8 on ``grid_pallas`` (half with fused spills), 8
    on ``grid_dense``; every column of at least 31 tiles with a partial
    last K1 and K4 block, spill capacity the capacity, the population
    within it, and hotspots of more than ``K1_LIST_CAP`` agents, which see
    each other, in columns of their own, no dense column past its
    ``col_cap``; at least one fused case starts with more spills than
    K1b's lanes, so K2's storm branch runs."""
    cases = scenes.wide_cases()
    assert [c.fast[0] for c in cases] == ["grid_pallas"] * 8 + \
        ["grid_dense"] * 8
    assert [c.config["fused_spills"] for c in cases[:8]] == \
        [True] * 4 + [False] * 4
    storm = 0
    for case in cases:
        cfg = scenes.fuzz_config(case, case.fast[0])
        g = cfg.grid
        bcfg = scenes.bucket_config(cfg)
        dcfg = zd.DenseConfig.create(
            g.width, g.height, g.offset, cfg.max_eyesight, cfg.capacity,
            tile_size=cfg.bucket_tile_size or None,
            col_headroom=cfg.dense_col_headroom)
        assert 120.0 - 0.1 <= g.width <= 200.0 + 2 * bcfg.tile_size
        for ty in (bcfg.ty, dcfg.ty):
            assert ty >= scenes.WIDE_MIN_TILES, case.name
            assert ty % zb.K1_TILES_PER_BLOCK, case.name
        assert zd.K4_TILES_PER_BLOCK == zb.K1_TILES_PER_BLOCK
        assert cfg.spill_capacity == cfg.capacity == scenes.WIDE_CAPACITY
        n = case.positions.shape[0]
        assert n + 10 * len(case.sources) * case.n_steps <= cfg.capacity
        assert float(case.eyesight.min()) >= 1.8
        assert case.dt == scenes.WIDE_DT and case.n_steps == scenes.WIDE_STEPS
        pos = torch.as_tensor(case.positions)
        col = torch.floor(pos[:, 0] / dcfg.tile_size).long()
        assert int(torch.bincount(col).max()) <= dcfg.col_cap, case.name
        hot = case.positions[:scenes.WIDE_HOTSPOT_AGENTS[0]]
        assert np.ptp(hot, axis=0).max() <= 2.0
        if case.fast[0] == "grid_pallas" and case.config["fused_spills"]:
            sim = scenes.build_fuzz_session(case, "grid_pallas", "cpu")
            storm += scenes.fuzz_spills(sim) > zb.FUSED_SPILL_LANES
    assert storm >= 1


# ---- F2: full right of way at t_i == 0 under integer priorities ----------


def _right_of_way_scene(pkg, backend, device=None):
    """Three agents (``ParityVelocity((1.0, 0.3))``, integer priorities,
    committed preferences): query 0 moves at exactly its preferred velocity
    and overlaps agent 1, so its time to collision is 0; agent 2 outranks
    it, shares its preferred velocity and moves fast.  The oracle takes
    agent 2's velocity under full right of way as ``v + 1 * (pref - v)``,
    which rounds off ``pref`` in f32, so the speed difference is one
    rounding step and the force jumps to ``force_cap``."""
    cfg = pkg.SimConfig(
        capacity=64, grid=pkg.GridConfig(36.0, 36.0, 3.0, (0.0, 0.0)),
        neighbor_backend=backend, max_eyesight=3.0, bucket_capacity=16,
        strip_tiles=6, sub_tiles=6, integer_priorities=True,
        commit_preferred_vel=True, pallas_interpret=True, dtype="float32")
    kw = {} if device is None else {"device": device}
    sim = pkg.Simulation(cfg, seed=0, **kw)
    hl = pkg.ParityVelocity((1.0, 0.3))
    lp = pkg.Zanlungo(1.2, 1.0, 0.0, 1.5, 2.0, 0.25, force_cap=100.0)
    sim.add_agents([(10.0, 10.0), (10.1, 10.0), (10.8, 10.9)], hl, lp, 2.0)
    vel = np.zeros((64, 2), np.float32)
    pref = np.zeros((64, 2), np.float32)
    vel[:3] = [(-1.0, -0.3), (0.5, 0.5), (25.302297592163086,
                                          21.707223892211914)]
    pref[:3] = [(-1.0, -0.3), (1.0, 0.3), (-1.0, -0.3)]
    if pkg is J:
        import jax.numpy as jnp
        sim.state = sim.state.replace(velocity=jnp.asarray(vel),
                                      preferred_vel=jnp.asarray(pref))
    else:
        sim.state = sim.state.replace(velocity=torch.as_tensor(vel),
                                      preferred_vel=torch.as_tensor(pref))
    sim.step(0.1)
    return scenes._by_uid(sim)


def test_full_right_of_way_at_zero_ttc_matches_brute():
    """F2 (the wide sweep case ``wide[grid_pallas 2]``): the kernels'
    integer-priority path took a full-right-of-way candidate's velocity
    as its preference exactly, so at t_i == 0 it saw no speed difference
    where the oracle saw one rounding step and ``force_cap``.  Every fast
    path now matches the port's and the JAX package's ``brute``; the JAX
    package's TPU kernel keeps the shortcut (its ``grid_pallas`` misses
    the capped force by metres here)."""
    f = np.float32
    assert f(21.707223892211914) + (f(-0.3) - f(21.707223892211914)) \
        != f(-0.3)
    uids, ref = _right_of_way_scene(J, "brute")
    for backend in ("brute", "grid_pallas", "grid_dense"):
        got_uids, got = _right_of_way_scene(T, backend, "cpu")
        assert got_uids == uids
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                                   err_msg=backend)
    _, tpu = _right_of_way_scene(J, "grid_pallas")
    assert float(np.abs(tpu - ref).max()) > 1.0
