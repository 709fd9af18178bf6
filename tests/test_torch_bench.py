"""The port's bench (``rmf_crowdsim_tpu_torch.bench``) on the CPU.

- ``compiled_parity_check`` on the CPU (each kernel's plain version) at
  bench.py's 4,096 agents passes, with the hotspot overflowing a bucket
  of ``grid_pallas``, so the spill repair runs (its ``brute`` leg, ~25 s
  on the CPU, is run once for the file and handed to each gate);
- ``scenes.build_rmf_hall`` against the same hall built with the JAX
  package as ``bench.py:308-390`` builds it (copied below, since bench.py
  builds it inline), the JAX side on ``brute``: the route ids equal agent
  for agent, positions after 5 steps at dt 0.25 equal by uid to 2e-4;
  ``time_rmf_routing`` reports the planner that planned;
- ``main`` prints exactly one JSON line, and a gate made to fail (the
  ``grid_pallas`` positions perturbed) raises out of ``main`` with
  nothing printed.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import bench, scenes

TOL = 2e-4
GATE_N = 4096
GATE_STEPS = 5
RMF_N = 2_000
RMF_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    """Four intra-op threads: the brute gate's [4096, 4096] pair tables
    take ~15 s a step on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def brute_gate(four_threads):
    """The gate's ``brute`` leg, run once for the file: the 4,096-agent
    bench scene with the hotspot, 5 steps at dt 1/60 -> (state,
    counters)."""
    rollout, params, st = scenes.build_bench(
        GATE_N, backend="brute", device="cpu", hotspot=True)
    return rollout(params, st, bench.BENCH_DT, GATE_STEPS)


def _spy_build_bench(monkeypatch, brute_gate, shift=0.0):
    """Wraps ``scenes.build_bench`` so each rollout records its counters
    by backend, the gate's ``brute`` leg returns ``brute_gate`` (the same
    inputs, computed once), and ``shift`` is added to the positions that
    ``grid_pallas`` returns."""
    seen = {}
    build = scenes.build_bench

    def spy(n, *a, backend="grid_pallas", **kw):
        rollout, params, st = build(n, *a, backend=backend, **kw)

        def wrapped(p, s, dt, n_steps):
            if (backend == "brute" and n == GATE_N and kw.get("hotspot")
                    and n_steps == GATE_STEPS and dt == bench.BENCH_DT):
                s, c = brute_gate
            else:
                s, c = rollout(p, s, dt, n_steps)
            seen.setdefault(backend, []).append((n, c))
            if backend == "grid_pallas" and shift:
                s = s.replace(position=s.position + shift)
            return s, c
        return wrapped, params, st

    monkeypatch.setattr(scenes, "build_bench", spy)
    return seen


def test_compiled_parity_check_overflows_a_bucket(monkeypatch, brute_gate):
    seen = _spy_build_bench(monkeypatch, brute_gate)
    assert bench.compiled_parity_check(device="cpu") is True
    (n, c), = seen["grid_pallas"]
    assert n == GATE_N
    assert int(c.max_cell_occupancy.max()) > \
        scenes.bench_config(n).bucket_capacity
    for backend in ("brute", "grid_pallas"):
        assert int(seen[backend][0][1].neighbor_truncated.max()) == 0


def _jax_rmf_hall(n_agents):
    """bench.py:308-390 on the JAX package, on ``brute``: (rollout,
    params, state, route ids)."""
    from rmf_crowdsim_tpu import (GridConfig, SimConfig, SimParams,
                                  Zanlungo, make_state)
    from rmf_crowdsim_tpu.core.step import build_rollout
    from rmf_crowdsim_tpu.models.rmf import RMFPlanner

    backend = "brute"
    verts, walls = [], []
    outer = [(0.0, 0.0), (200.0, 0.0), (200.0, 100.0), (0.0, 100.0)]
    verts += outer
    walls += [(0, 1), (1, 2), (2, 3), (3, 0)]
    for i, x in enumerate((40.0, 80.0, 120.0, 160.0)):
        b = len(verts)
        gap_lo = 40.0 + 5.0 * i
        verts += [(x, 0.0), (x, gap_lo), (x, gap_lo + 12.0), (x, 100.0)]
        walls += [(b, b + 1), (b + 2, b + 3)]
    planner = RMFPlanner(verts, walls, scale=2.0, radius=0.4,
                         max_routes=8192, max_route_len=64,
                         arrival_tolerance=0.5)
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=10.0)
    cfg = SimConfig(
        capacity=n_agents,
        grid=GridConfig(width=208.0, height=108.0, cell_size=2.0,
                        offset=(-4.0, -4.0)),
        neighbor_backend=backend,
        max_per_cell=32,
        max_eyesight=2.0,
        bucket_capacity=32,
        sub_tiles=2,
        strip_tiles=96,
        bucket_tile_size=5.3,
        use_pack_kernel=(backend == "grid_pallas"),
        spill_capacity=256,
        on_truncation="ignore",
        dtype="float32",
    )
    state = make_state(cfg)
    rng = np.random.default_rng(0)
    f = cfg.jdtype
    pos = np.stack([rng.uniform(2.0, 198.0, n_agents),
                    rng.uniform(2.0, 98.0, n_agents)], axis=-1)
    goal = (190.0, 90.0)
    route_ids = np.asarray([
        rid if (rid := planner.plan_route_cached(
            (float(p[0]), float(p[1])), goal)) is not None else -1
        for p in pos
    ])
    state = state.replace(
        position=jnp.asarray(pos, f),
        eyesight=jnp.full((n_agents,), 2.0, f),
        alive=jnp.ones((n_agents,), bool),
        uid=jnp.arange(n_agents, dtype=jnp.int32),
        hl_idx=jnp.zeros((n_agents,), jnp.int32),
        lp_idx=jnp.zeros((n_agents,), jnp.int32),
        route_id=jnp.asarray(route_ids, jnp.int32),
        route_wp=jnp.zeros((n_agents,), jnp.int32),
        priority=jnp.arange(n_agents, dtype=f),
        next_uid=jnp.asarray(n_agents, jnp.int32),
    )
    params = SimParams(hl=(planner.init_params(),), lp=(lp.init_params(),),
                       sources=None)
    return build_rollout(cfg, [planner], [lp]), params, state, route_ids


def test_rmf_hall_matches_jax():
    jr, jp, js, j_routes = _jax_rmf_hall(RMF_N)
    tr, tp, ts, planner, t_routes, plan_s = scenes.build_rmf_hall(
        RMF_N, "grid_pallas", "cpu")
    np.testing.assert_array_equal(t_routes, j_routes)
    assert (t_routes >= 0).sum() > RMF_N // 2 and plan_s > 0
    start = ts.position.numpy().copy()
    js, jc = jr(jp, js, bench.RMF_DT, RMF_STEPS)
    ts, tc = tr(tp, ts, bench.RMF_DT, RMF_STEPS)
    assert int(tc.neighbor_truncated.max()) == 0
    np.testing.assert_array_equal(tc.n_alive.numpy(), np.asarray(jc.n_alive))
    want = np.asarray(js.position)[np.argsort(np.asarray(js.uid))]
    got = ts.position[torch.argsort(ts.uid)].numpy()
    assert np.abs(got - start).max() > 1.0  # the routed agents walked
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    sps, host = bench.time_rmf_routing(RMF_N, n_steps=1, device="cpu")
    assert sps > 0
    assert host["route_backend"] == planner.route_backend == "native"
    assert host["routed_agents"] == int((t_routes >= 0).sum())
    assert host["distinct_routes"] == len(set(t_routes[t_routes >= 0]))


def test_main_prints_one_json_line(monkeypatch, capsys, brute_gate):
    seen = _spy_build_bench(monkeypatch, brute_gate)
    assert bench.main(["--n", "1024", "--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "sim_steps_per_sec_1024_zanlungo_grid"
    assert result["unit"] == "steps/s" and result["value"] > 0
    assert result["vs_baseline"] == result["value"] / 100.0
    extra = result["extra"]
    assert extra["compiled_parity"] is True
    assert extra["neighbor_backend"] == "grid_pallas"
    assert extra["device"] == "cpu" and "card" not in extra
    assert [n for n, _ in seen["brute"]] == [GATE_N]
    assert [n for n, _ in seen["grid_pallas"]] == [GATE_N] + [1024] * 4


def test_failed_gate_raises_out_of_main(monkeypatch, capsys, brute_gate):
    """``grid_pallas`` positions shifted by 1e-3 (five times the gate's
    tolerance): ``main`` raises and prints no number."""
    _spy_build_bench(monkeypatch, brute_gate, shift=1e-3)
    with pytest.raises(AssertionError, match="brute oracle"):
        bench.main(["--n", "1024", "--quick", "--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_bench_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.run(n=1024, quick=True)
