"""Loud neighbour-truncation enforcement on the port: the cases of
tests/test_truncation.py through the port's ``Simulation(cfg,
device="cpu")``.

The reference's per-cell sets are unbounded (location_hash_2d.rs:15); the
fixed-K gathers and fixed-capacity buckets can drop neighbour
interactions when a cell or tile overflows.  These tests show that the
overflow is detected and raised by default
(``SimConfig.on_truncation="raise"``) on the ``grid`` backend and the
``grid_pallas`` backend (its kernels' plain versions on the CPU), on the
one-step and the rollout paths, counted in ``ignore`` mode, and repaired
exactly by the spill repair, down to the JAX package's full-scatter
scene.  The two cases marked ``slow`` in the JAX file keep the marker.
"""

import numpy as np
import pytest

from rmf_crowdsim_tpu_torch import (
    ConstantVelocity,
    GridConfig,
    NeighborTruncationError,
    NoLocalPlan,
    SimConfig,
    Simulation,
    Zanlungo,
)


def _dense_sim(on_truncation: str, backend: str = "grid",
               max_per_cell: int = 2):
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(100.0, 100.0, 5.0, (-50.0, -50.0)),
        neighbor_backend=backend,
        max_per_cell=max_per_cell,
        max_eyesight=5.0,
        on_truncation=on_truncation,
    )
    sim = Simulation(cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    # 5 agents inside one 5 m cell: 3 more than max_per_cell.
    pts = [(1.0 + 0.2 * i, 1.0) for i in range(5)]
    sim.add_agents(pts, hl, lp, 5.0)
    return sim


def test_grid_overflow_raises():
    sim = _dense_sim("raise")
    with pytest.raises(NeighborTruncationError, match="3 agents"):
        sim.step(1.0 / 60.0)


def test_grid_overflow_ignore_reports():
    sim = _dense_sim("ignore")
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 3
    assert int(sim.last_events.max_cell_occupancy) == 5


def test_rollout_overflow_raises():
    sim = _dense_sim("raise")
    with pytest.raises(NeighborTruncationError):
        sim.run(3, 1.0 / 60.0)


def test_grid_overflow_nobody_sees_is_silent():
    """Round-2 verdict weak #6: overflow whose dropped members sit beyond
    every querier's eyesight has zero physics impact and must NOT raise.
    Same 5-agent cluster (cap 2) but eyesight 0.1 < the 0.2 m spacing —
    nobody can see anybody, so the audit finds no impactful drop."""
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(100.0, 100.0, 5.0, (-50.0, -50.0)),
        neighbor_backend="grid",
        max_per_cell=2,
        max_eyesight=5.0,
        on_truncation="raise",
    )
    sim = Simulation(cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    pts = [(1.0 + 0.2 * i, 1.0) for i in range(5)]
    sim.add_agents(pts, hl, lp, 0.1)  # eyesight 0.1
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 0


def test_grid_overflow_partially_seen_counts_seen_only():
    """Mixed case: the cluster is blind (eyesight 0.1) but one far-seeing
    agent stands in the next cell ~4.5 m away — the 3 dropped members are
    inside ITS eyesight, so all 3 count as impactful."""
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(100.0, 100.0, 5.0, (-50.0, -50.0)),
        neighbor_backend="grid",
        max_per_cell=2,
        max_eyesight=5.0,
        on_truncation="ignore",
    )
    sim = Simulation(cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    sim.add_agents([(1.0 + 0.2 * i, 1.0) for i in range(5)], hl, lp, 0.1)
    sim.add_agents([(6.0, 1.0)], hl, lp, 5.0)  # the watcher (next cell)
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 3


def test_no_overflow_is_silent():
    sim = _dense_sim("raise", max_per_cell=8)
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 0
    sim.run(3, 1.0 / 60.0)


def _pallas_overflow_sim(**cfg_kw):
    cfg = SimConfig(
        capacity=64,
        grid=GridConfig(32.0, 32.0, 2.0, (0.0, 0.0)),
        neighbor_backend="grid_pallas",
        max_eyesight=2.0,
        bucket_capacity=8,
        strip_tiles=14,
        sub_tiles=14,
        on_truncation="raise",
        **cfg_kw,
    )
    sim = Simulation(cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    # 12 agents in one 2 m supertile, bucket capacity 8.
    pts = [(1.0 + 0.05 * i, 1.0) for i in range(12)]
    sim.add_agents(pts, hl, lp, 2.0)
    return sim


def test_pallas_bucket_overflow_raises_without_spill_patch():
    """grid_pallas backend: with the spill repair off, tile occupancy past
    bucket_capacity raises through the fused path's dropped counter."""
    sim = _pallas_overflow_sim(spill_capacity=0)
    with pytest.raises(NeighborTruncationError, match="4 agents"):
        sim.step(1.0 / 60.0)


@pytest.mark.slow
def test_pallas_bucket_overflow_repaired_by_spill_patch():
    """Default config: the same overflowing scene steps cleanly — the
    spill patch recomputes the overflow agents and their neighborhoods
    exactly (no truncation event), matching the brute backend."""
    sim = _pallas_overflow_sim()  # defaults: spill_capacity=128
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 0

    ref_cfg = SimConfig(capacity=64, neighbor_backend="brute",
                        on_truncation="raise")
    ref = Simulation(ref_cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    ref.add_agents([(1.0 + 0.05 * i, 1.0) for i in range(12)], hl, lp, 2.0)
    ref.step(1.0 / 60.0)
    import numpy as np

    got = np.asarray([sim.agents[k].position for k in sorted(sim.agents)])
    want = np.asarray([ref.agents[k].position for k in sorted(ref.agents)])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_brute_backend_never_truncates():
    cfg = SimConfig(capacity=32, neighbor_backend="brute",
                    on_truncation="raise")
    sim = Simulation(cfg, device="cpu")
    hl = ConstantVelocity((0.1, 0.0))
    lp = NoLocalPlan()
    sim.add_agents([(0.0, 0.0), (0.1, 0.0), (0.2, 0.0)], hl, lp, 5.0)
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 0


@pytest.mark.slow
def test_pallas_spill_dense_hotspot_full_scatter_branch():
    """Dense-hotspot spill repair parity on the JAX package's
    full-scatter scene.

    The JAX spill patch normally scatters only the queries within
    eyesight of some spill, capped at 32 rows per spill group, and falls
    back to scattering every window query when a hotspot affects more
    (``full_scatter`` in ops/zanlungo_pallas.spill_patch).  The port's
    repair (K2) writes every affected row in one pass, so this scene,
    which crosses the JAX cap by construction, checks it at its heaviest:
    60 agents blob in one 6 m tile of bucket capacity 8 (52 spills) plus
    8 ring tiles of exactly 8 agents each, all within the 6 m eyesight of
    every spill, so 52 * (9*8 + 1) = 3796 rows are affected.  Physics
    must still match the brute backend (zanlungo.rs:49-218 semantics,
    repair doctrine of location_hash_2d.rs:275-306)."""
    hotspot = [(15.0 + 0.3 * np.cos(2 * np.pi * i / 60.0),
                15.0 + 0.3 * np.sin(2 * np.pi * i / 60.0) + 0.002 * i)
               for i in range(60)]
    # Tile (2, 2) covers [12, 18)^2; for each of the 8 neighbor tiles,
    # 8 agents at the point of that tile nearest the blob, nudged 0.5 m
    # inside — every ring agent is <= 5.1 m from every blob agent
    # (eyesight 6), and each ring tile holds exactly bucket_capacity.
    ring = []
    for bx, by in ((11.5, 11.5), (15.0, 11.5), (18.5, 11.5),
                   (11.5, 15.0), (18.5, 15.0),
                   (11.5, 18.5), (15.0, 18.5), (18.5, 18.5)):
        ring += [(bx + 0.04 * j, by + 0.03 * j) for j in range(8)]
    pts = hotspot + ring

    def make(backend, **kw):
        cfg = SimConfig(
            capacity=160,
            grid=GridConfig(36.0, 36.0, 2.0, (0.0, 0.0)),
            neighbor_backend=backend,
            max_per_cell=64,
            max_eyesight=6.0,
            on_truncation="raise",
            **kw,
        )
        sim = Simulation(cfg, device="cpu")
        hl = ConstantVelocity((0.1, 0.0))
        lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
        sim.add_agents(pts, hl, lp, 6.0)
        return sim

    sim = make("grid_pallas", bucket_capacity=8, bucket_tile_size=6.0,
               strip_tiles=6, sub_tiles=14, spill_capacity=64)
    sim.step(1.0 / 60.0)
    assert int(sim.last_events.neighbor_truncated) == 0

    ref = make("brute")
    ref.step(1.0 / 60.0)
    got = np.asarray([sim.agents[k].position for k in sorted(sim.agents)])
    want = np.asarray([ref.agents[k].position for k in sorted(ref.agents)])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
