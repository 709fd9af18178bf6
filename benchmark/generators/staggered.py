"""``staggered``: a host crowd generator (the reference's CrowdGenerator
trait, source_sink.rs:30-33) of ``rate`` agents a second, spread evenly
from the source's phase.  ``MonotonicCrowd`` rounds ``rate * dt`` every
step, so at dt 0.25 it gives either none or one agent every 0.25 s."""

import math

import torch


def count(rate: float, phase: float, dt: float, k: int) -> int:
    """The ``k``-th call's count: ``floor(phase + (k+1) r) - floor(phase +
    k r)`` with ``r = rate * dt``."""
    r = rate * dt
    return math.floor(phase + (k + 1) * r) - math.floor(phase + k * r)


class StaggeredCrowd:
    def __init__(self, rate: float, phase: float):
        self.rate = float(rate)
        self.phase = float(phase)
        self.calls = 0

    def get_number_to_spawn(self, dt: float) -> int:
        n = count(self.rate, self.phase, dt, self.calls)
        self.calls += 1
        return n


def program(spec: dict, phase: float):
    return StaggeredCrowd(spec["rate"], phase)


def reference(spec: dict, phases, dt: float):
    phases = [float(p) for p in phases]

    def requests(k):
        return torch.tensor([count(spec["rate"], p, dt, k) for p in phases],
                            dtype=torch.long)

    return spec["rate"], requests
