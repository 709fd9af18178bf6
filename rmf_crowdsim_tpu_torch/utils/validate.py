"""State invariant checks.

Counterpart of ``rmf_crowdsim_tpu/utils/validate.py`` (:20-49).  What can
go wrong in a state is numeric (NaN/Inf positions from pathological force
configs; the reference clamps at 1e15, zanlungo.rs:165-167) and structural
(duplicate uids, dead slots with stale flags).  ``validate_state`` returns
a dict of violation counts as 0-d tensors on the state's device, with no
host read; ``check_state`` fetches them in one transfer and raises.
"""

from __future__ import annotations

import torch

from ..core.state import SimState


def validate_state(state: SimState) -> dict:
    """Invariant audit without a host read; every entry should be 0."""
    i32 = torch.int32
    alive = state.alive
    finite_pos = torch.isfinite(state.position).all(-1)
    finite_vel = torch.isfinite(state.velocity).all(-1)
    live_uid = torch.where(alive, state.uid, -1)
    # Duplicate live uids: sort and compare neighbours (uids are unique
    # and non-negative for live agents).
    s = torch.sort(live_uid).values
    dup = (s[1:] == s[:-1]) & (s[1:] >= 0)
    return {
        "nonfinite_position": (alive & ~finite_pos).sum(dtype=i32),
        "nonfinite_velocity": (alive & ~finite_vel).sum(dtype=i32),
        "negative_live_uid": (alive & (state.uid < 0)).sum(dtype=i32),
        "duplicate_live_uid": dup.sum(dtype=i32),
        "uid_above_allocator": (alive & (state.uid >= state.next_uid)).sum(
            dtype=i32),
        "waypoint_negative": (alive & (state.next_waypoint < 0)).sum(
            dtype=i32),
    }


def check_state(state: SimState) -> None:
    """Host-side assert wrapper: raises ValueError listing violations."""
    report = validate_state(state)
    counts = torch.stack(list(report.values())).tolist()
    bad = {k: v for k, v in zip(report, counts) if v != 0}
    if bad:
        raise ValueError(f"simulation state invariants violated: {bad}")
