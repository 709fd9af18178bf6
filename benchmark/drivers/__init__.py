"""Drivers, one module a kind (``drivers/<kind>.py``, named by the
traffic file's ``driver``), each with a ``Driver(cfg, traffic, seed,
device, trace)`` that gives the harness:

- ``warm_up()``: every shape the window uses, run once;
- ``unit()``: one unit of the measured window (an episode; a ``step()``),
  returning (steps, agent-steps), where agent-steps counts the agents each
  step moved (those alive after it plus those it destroyed);
- ``min_units``: the window's least number of units;
- ``traced_unit()``: the unit run under the profiler;
- ``counters()``: the window's steadiness counters;
- ``check(seed)``: after the window, the numbers that decide ``correct``;
- ``k1_states()``: states whose K1 inputs the roofline metric counts;
- ``control(seed, dtype)``: the reference in ``dtype`` at the checked
  steps, for ``calibrate.py``;
- ``free()``: drops what the check kept.

The shared pieces live here.
"""

from __future__ import annotations

import contextlib

import torch

from .. import scene
from ..reference import compare, crowd as ref

COUNTERS = ("n_alive", "n_destroyed", "n_spawned", "spawn_dropped",
            "out_of_bounds", "max_cell_occupancy", "neighbor_truncated",
            "n_waypoint_reached")


def span(trace: bool, name: str):
    """A benchmark-side span in the traced unit; nothing outside it."""
    if trace:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def compare_step(world, pre: dict, post: dict, step_index: int,
                 events=None):
    """The program's step ``pre`` -> ``post`` (state fields) against the
    reference's step from ``pre``: a :class:`compare.Verdict`."""
    a = compare.agents(pre, int(pre["next_uid"]))
    ref_post, ref_ev, ctx = ref.step(world, a, step_index)
    got = compare.agents(post, int(post["next_uid"]))
    v = compare.judge(world, ref_post, got, ctx)
    if events is not None:
        v.events_off = compare.events_off(ref_ev, events)
    return v


CONTROL_SAMPLE = 1 << 16


def control_step(world, pre: dict, step_index: int, dtype, seed: int):
    """The control: the reference computed in ``dtype`` in the program's
    place, judged against the reference in the state's dtype over a
    sample of ``CONTROL_SAMPLE`` agents drawn from ``seed`` (the whole
    state steps; only the sample's forces are worked out and judged)."""
    a = compare.agents(pre, int(pre["next_uid"]))
    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(a.uid.shape[0], generator=g)[:CONTROL_SAMPLE]
    only = a.uid[pick.to(a.uid.device)]
    ref_post, ref_ev, _ = ref.step(world, a, step_index, only=only)
    low_post, low_ev, _ = ref.step(world, a.to(dtype), step_index, only=only)
    keep_r = torch.isin(ref_post.uid, only)
    keep_l = torch.isin(low_post.uid, only)
    v = compare.judge(world, ref_post.take(keep_r), low_post.take(keep_l))
    v.events_off = compare.events_off(ref_ev, {
        "spawned": compare.pairs(low_ev.spawned_uid.cpu(),
                                  low_ev.spawned_pos.float().cpu()),
        "reached": compare.pairs(low_ev.reached_uid.cpu(),
                                  low_ev.reached_pos.float().cpu()),
        "destroyed": compare.pairs(low_ev.destroyed_uid.cpu())})
    return v




def make(cfg: dict, traffic: dict, seed: int, device, trace: bool = False):
    """The driver that the traffic file names."""
    return scene.part("drivers", traffic["driver"]).Driver(
        cfg, traffic, seed, device, trace)
