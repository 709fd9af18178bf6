"""The port against the sequential reference-semantics oracle
(tests/reference_oracle.py, float64, no JAX): the six scenarios of
tests/test_reference_parity.py, each with its own tolerance, through the
port's ``Simulation(cfg, device="cpu")``.

1. ~1k streaming agents (SourceSink + MonotonicCrowd + sink removal) with
   a constant-velocity planner, bitwise;
2. static agents with per-id directions (the viz stub), 64 ULP;
3. waypoint chains and loops, bitwise;
4. co-located sources, bitwise;
5. isolated Zanlungo pairs, 1e-11;
6. a dense Zanlungo crowd, 1e-9.
"""

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import (
    ConstantVelocity,
    GridConfig,
    NoLocalPlan,
    ParityVelocity,
    SimConfig,
    Simulation,
    SourceSink,
    MonotonicCrowd,
)
from tests.reference_oracle import OracleSim, OracleSource


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def positions_of(sim: Simulation):
    return {k: v.position for k, v in sim.agents.items()}


def test_streaming_trajectories_match_oracle_bitwise():
    """1k-scale streaming: 25 sources x ~40 live agents each, 60 steps.
    Positions must match the sequential oracle BITWISE (float64; both
    sides compute p + v*dt with the same f64 ops)."""
    cfg = SimConfig(
        capacity=2048,
        grid=GridConfig(4000.0, 4000.0, 20.0, (-2000.0, -2000.0)),
        neighbor_backend="brute",
        dtype="float64",
    )
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()

    lp = NoLocalPlan()
    n_sources = 25
    for s in range(n_sources):
        # Sources spread out; sinks 40 m away; speed 1 m/s; dt 1 s.
        y = (s - n_sources / 2) * 50.0
        hl = ConstantVelocity((1.0, 0.0))
        sim.add_source_sink(
            SourceSink(source=(0.0, y), waypoints=[(40.0, y)],
                       radius_sink=1.0, crowd_generator=MonotonicCrowd(1.0),
                       high_level_planner=hl, local_planner=lp,
                       agent_eyesight_range=5.0)
        )

        def mk(vel):
            def hl_fn(agent, t):
                return vel
            return hl_fn

        oracle.add_source(OracleSource(
            source=(0.0, y), waypoints=[(40.0, y)], radius_sink=1.0,
            rate=1.0, eyesight=5.0, hl=mk((1.0, 0.0)),
        ))

    peak = 0
    for step in range(60):
        sim.step(1.0)
        oracle.step(1.0)
        got = positions_of(sim)
        want = {aid: a.position for aid, a in oracle.agents.items()}
        assert got.keys() == want.keys(), f"step {step}"
        peak = max(peak, len(got))
        for k in got:
            assert got[k][0] == want[k][0] and got[k][1] == want[k][1], (
                step, k, got[k], want[k]
            )
    assert peak >= 975  # ~1k concurrently-alive agents at steady state


def test_parity_velocity_matches_oracle():
    """Static population with id-parity directions (viz stub,
    main.rs:26-29): 400 agents, 50 steps, bitwise float64 parity."""
    cfg = SimConfig(capacity=512, neighbor_backend="brute", dtype="float64")
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()

    hl = ParityVelocity((0.7, 1.3))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-100, 100, (400, 2))
    ids = sim.add_agents([tuple(p) for p in pts], hl, NoLocalPlan(), 10.0)

    def hl_fn(agent, t):
        v = (0.7, 1.3)
        return (-v[0], -v[1]) if agent.agent_id % 2 == 0 else v

    for p, aid in zip(pts, ids):
        got_id = oracle.add_agent(tuple(p), hl_fn, 10.0)
        assert got_id == aid

    for step in range(50):
        sim.step(1.0 / 60.0)
        oracle.step(1.0 / 60.0)
    got = positions_of(sim)
    want = {aid: a.position for aid, a in oracle.agents.items()}
    assert got.keys() == want.keys()
    g = np.asarray([got[k] for k in sorted(got)])
    w = np.asarray([want[k] for k in sorted(want)])
    # The JAX package's tolerance: a fused p + v*dt rounds once where the
    # scalar oracle rounds the multiply and add separately, <= 1 ULP a
    # step over 50 steps.  (The streaming test above is exactly bitwise
    # because its velocity*dt products are exact.)
    np.testing.assert_array_max_ulp(g, w, maxulp=64)


def test_multiwaypoint_and_looping_match_oracle():
    """Multi-waypoint chains (advance, lib.rs:325-334) and loop_forever
    wraparound (lib.rs:318-320) against the sequential oracle, bitwise."""
    cfg = SimConfig(
        capacity=256,
        grid=GridConfig(1000.0, 1000.0, 20.0, (-500.0, -500.0)),
        neighbor_backend="brute",
        dtype="float64",
    )
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()
    lp = NoLocalPlan()

    chains = [
        # (source, waypoints, loop)
        ((0.0, 0.0), [(10.0, 0.0), (20.0, 0.0), (30.0, 0.0)], False),
        ((0.0, 50.0), [(6.0, 50.0)], True),  # loops forever
        ((0.0, -50.0), [(8.0, -50.0), (16.0, -50.0)], True),
    ]
    for src, wps, loop in chains:
        hl = ConstantVelocity((1.0, 0.0))
        sim.add_source_sink(SourceSink(
            source=src, waypoints=wps, radius_sink=1.0,
            crowd_generator=MonotonicCrowd(1.0), high_level_planner=hl,
            local_planner=lp, agent_eyesight_range=5.0, loop_forever=loop))

        def mk():
            def hl_fn(agent, t):
                return (1.0, 0.0)
            return hl_fn

        oracle.add_source(OracleSource(
            source=src, waypoints=list(wps), radius_sink=1.0, rate=1.0,
            eyesight=5.0, loop_forever=loop, hl=mk()))

    for step in range(50):
        sim.step(1.0)
        oracle.step(1.0)
        got = {k: (v.position, v.next_waypoint)
               for k, v in sim.agents.items()}
        want = {aid: (a.position, a.next_waypoint)
                for aid, a in oracle.agents.items()}
        assert got.keys() == want.keys(), f"step {step}"
        for k in got:
            assert got[k][0] == want[k][0], (step, k)
            assert got[k][1] == want[k][1], (step, k)


def test_colocated_sources_match_oracle():
    """Two sources inside each other's clearance disc: all clearance
    checks read the PRE-spawn index (lib.rs:199-222 first collect()), so
    both co-located sources spawn on step 0, then block each other's
    later spawns via the live agents; must match the oracle step for
    step."""
    cfg = SimConfig(
        capacity=128,
        grid=GridConfig(1000.0, 1000.0, 20.0, (-500.0, -500.0)),
        neighbor_backend="brute",
        dtype="float64",
    )
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()
    lp = NoLocalPlan()
    for src in [(0.0, 0.0), (0.25, 0.0), (30.0, 0.0)]:
        hl = ConstantVelocity((1.0, 0.0))
        sim.add_source_sink(SourceSink(
            source=src, waypoints=[(src[0] + 15.0, 0.0)], radius_sink=1.0,
            crowd_generator=MonotonicCrowd(1.0), high_level_planner=hl,
            local_planner=lp, agent_eyesight_range=5.0))

        def mk():
            def hl_fn(agent, t):
                return (1.0, 0.0)
            return hl_fn

        oracle.add_source(OracleSource(
            source=src, waypoints=[(src[0] + 15.0, 0.0)], radius_sink=1.0,
            rate=1.0, eyesight=5.0, hl=mk()))

    for step in range(30):
        sim.step(1.0)
        oracle.step(1.0)
        got = positions_of(sim)
        want = {aid: a.position for aid, a in oracle.agents.items()}
        assert got.keys() == want.keys(), f"step {step}"
        for k in got:
            assert got[k] == want[k], (step, k)


def test_zanlungo_pair_trajectories_match_oracle():
    """Zanlungo forces active (VERDICT item 4): isolated head-on pairs —
    each agent sees exactly ONE neighbor, so force sums have no
    order-ambiguity and the comparison isolates the 170-line force math
    (zanlungo.rs:49-218) against an independent scalar transcription.
    float64; only the transcendentals' ULPs separate the two."""
    from rmf_crowdsim_tpu_torch import Zanlungo
    from tests.reference_oracle import OracleZanlungo

    cfg = SimConfig(capacity=64, neighbor_backend="brute", dtype="float64")
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()

    zp = dict(agent_scale=1.4, obstacle_scale=1.0, reaction_time=0.0,
              force_distance=2.0, agent_mass=1.7, agent_radius=0.3)
    lp = Zanlungo(**zp)
    olp = OracleZanlungo(**zp)
    hl = ParityVelocity((0.9, 0.0))  # even ids -> -v, odd ids -> +v

    # 12 pairs, 60 m apart (eyesight 5 m: pairs never see each other).
    # Slight y offsets break symmetry so slerp/right-of-way branches fire
    # on the lower-priority (even-id) agent.
    pts = []
    for i in range(12):
        y = i * 60.0
        pts.append((2.0, y))          # even id, moves -x
        pts.append((-2.0, y + 0.13))  # odd id, moves +x
    sim.add_agents(pts, hl, lp, 5.0)

    def hl_fn(agent, t):
        v = (0.9, 0.0)
        return (-v[0], -v[1]) if agent.agent_id % 2 == 0 else v

    for p in pts:
        oracle.add_agent(p, hl_fn, 5.0, olp)

    for _ in range(40):
        sim.step(1.0 / 60.0)
        oracle.step(1.0 / 60.0)
    got = positions_of(sim)
    want = {aid: a.position for aid, a in oracle.agents.items()}
    assert got.keys() == want.keys()
    g = np.asarray([got[k] for k in sorted(got)])
    w = np.asarray([want[k] for k in sorted(want)])
    # Agents must actually have interacted (forces nonzero) for this to
    # test anything: a pure ParityVelocity trajectory would differ.
    free_flight = np.asarray(
        [(p[0] - 0.9 * (40 / 60.0), p[1]) for p in pts[::2]]
    )
    assert not np.allclose(g[::2], free_flight, atol=1e-6), (
        "forces never fired — scene is not exercising Zanlungo"
    )
    np.testing.assert_allclose(g, w, rtol=1e-11, atol=1e-11)


def test_zanlungo_dense_crowd_matches_oracle():
    """Dense random crowd, every branch of the force math live, 25 steps.
    f64 sum order (a tree reduction vs sequential) and transcendental
    ULPs bound the tolerance."""
    from rmf_crowdsim_tpu_torch import Zanlungo
    from tests.reference_oracle import OracleZanlungo

    cfg = SimConfig(capacity=64, neighbor_backend="brute", dtype="float64")
    sim = Simulation(cfg, device="cpu")
    oracle = OracleSim()

    zp = dict(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
              force_distance=1.5, agent_mass=2.0, agent_radius=0.25)
    # force_cap keeps overlapping random pairs finite (repo extension,
    # mirrored in the oracle).
    lp = Zanlungo(**zp, force_cap=50.0)
    olp = OracleZanlungo(**zp, force_cap=50.0)
    hl = ParityVelocity((0.6, -0.4))

    rng = np.random.default_rng(7)
    pts = [tuple(p) for p in rng.uniform(-6.0, 6.0, (40, 2))]
    sim.add_agents(pts, hl, lp, 4.0)

    def hl_fn(agent, t):
        v = (0.6, -0.4)
        return (-v[0], -v[1]) if agent.agent_id % 2 == 0 else v

    for p in pts:
        oracle.add_agent(p, hl_fn, 4.0, olp)

    for _ in range(25):
        sim.step(1.0 / 60.0)
        oracle.step(1.0 / 60.0)
    got = positions_of(sim)
    want = {aid: a.position for aid, a in oracle.agents.items()}
    assert got.keys() == want.keys()
    g = np.asarray([got[k] for k in sorted(got)])
    w = np.asarray([want[k] for k in sorted(want)])
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
