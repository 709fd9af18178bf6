"""The yardstick's frozen copies give what the program's originals give
today, on small seeded states."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import scene, yardstick
from benchmark.planners import rmf
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
from rmf_crowdsim_tpu_torch.utils import roofline
from rmf_crowdsim_tpu_torch.utils.profiling import StepTimer


def test_step_percentiles_match_step_timer():
    t = np.random.default_rng(3).exponential(0.004, 257)
    timer = StepTimer()
    for x in t:
        timer.record(float(x))
    want = timer.summary()
    got = yardstick.step_percentiles(t)
    assert got["p50_ms"] == want["p50_ms"] and got["p95_ms"] == want["p95_ms"]
    assert got["steps"] == want["steps"]


@pytest.mark.parametrize("name", ["crowd_1m", "rmf_hall"])
def test_tile_geometry_matches_bucket_config(name):
    cfg = scene.load("configs", name)
    geo = yardstick.TileGeometry.of_config(cfg["sim"])
    bc = scenes.bucket_config(scene.sim_config(cfg))
    assert (geo.tx, geo.ty, geo.bucket, geo.slots) == (bc.tx, bc.ty,
                                                         bc.bucket, bc.slots)
    assert geo.tile_size == bc.tile_size and geo.offset == bc.offset


def test_crowd_config_is_the_stream_config():
    cfg = scene.sim_config(scene.load("configs", "crowd_1m"))
    assert cfg == scenes.stream_config(1_000_000, 1_048_576)


def test_hall_planner_and_zanlungo_match_build_rmf_hall():
    cfg = scene.load("configs", "rmf_hall")
    _, params, _, planner, _, _ = scenes.build_rmf_hall(4, device="cpu")
    ours = rmf.rmf_planner(cfg)
    rng = np.random.default_rng(5)
    for _ in range(12):
        a = tuple(rng.uniform([4, 4], [196, 96]).round())
        b = tuple(rng.uniform([4, 4], [196, 96]).round())
        ra, rb = planner.plan_route_cached(a, b), ours.plan_route_cached(a, b)
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert planner.route(ra) == ours.route(rb)
    zp = scene.zanlungo(cfg).init_params("cpu")
    for f in dataclasses.fields(zp):
        assert float(getattr(zp, f.name)) == float(getattr(params.lp[0],
                                                           f.name))


def test_square_lattice_and_legs_match_the_stream_scene():
    cfg = scene.load("configs", "crowd_1m")
    traffic = scene.load("traffic", "streams")
    plan = scene.source_plan(traffic, cfg, 7)
    src = scenes.stream_sources(1024, cfg["sim"]["grid"]["width"])
    assert np.array_equal(plan.pos, src)
    legs = torch.as_tensor(scene.straight_legs(plan), dtype=torch.float32)
    assert torch.equal(legs, scenes.stream_routes(src, torch.float32,
                                                  "cpu").points)
    hl, lp = object(), object()
    ours = scene.make_sinks(plan, hl, lp)
    theirs = scenes.stream_sinks(src, hl, lp)
    for a, b in zip(ours, theirs):
        assert (a.source, list(a.waypoints), a.radius_sink, a.loop_forever,
                a.agent_eyesight_range, a.crowd_generator.rate) == (
            b.source, list(b.waypoints), b.radius_sink, b.loop_forever,
            b.agent_eyesight_range, b.crowd_generator.rate)


def _bench_state(n):
    """A small bench crowd a few steps in (moving, with pair forces)."""
    rollout, params, st = scenes.build_bench(n, device="cpu")
    st, _ = rollout(params, st, 1.0 / 60.0, 3)
    return scenes.bench_config(n), params, st


def test_k1_counts_match_roofline():
    n = 1024
    config, params, st = _bench_state(n)
    bcfg = scenes.bucket_config(config)
    geo = yardstick.TileGeometry.create(
        config.grid.width, config.grid.height, config.grid.offset,
        config.max_eyesight, config.bucket_capacity, config.strip_tiles,
        config.sub_tiles, config.bucket_tile_size)
    rec = torch.zeros_like(st.velocity)
    packed_t, packed_T, _, occ, dropped = zb.bucketize(
        bcfg, st.position, st.velocity, st.preferred_vel, rec, st.priority,
        st.eyesight, rec, st.alive)
    assert int(dropped) == 0
    zp5 = zb.zparams5(params.lp[0])
    want = roofline.k1_work(bcfg, zp5, packed_t, packed_T)
    got = yardstick.k1_work(geo, st.position, st.velocity, st.eyesight,
                            st.alive, 0.25)
    assert (got.tests, got.pairs, got.forced) == (want.tests, want.pairs,
                                                  want.forced)
    assert got.ops(True) == want.ops(True)
    _, n_live = yardstick.k1_inputs(geo, st.position, st.velocity,
                                    st.eyesight, st.alive)
    assert n_live == n
    assert yardstick.k1_bytes(geo, n_live) == roofline.k1_bytes(bcfg, n_live)
    assert yardstick.k3_bytes(n, bcfg.slots) == roofline.k3_bytes(n,
                                                                  bcfg.slots)
    assert yardstick.bound_ms(10**9, 0) == roofline.Bound(10**9).ms
