"""The median ms of a ``Simulation.step()`` call over the measured
window's steps (the tail's companion), by the frozen percentile
arithmetic."""

from ..yardstick import step_percentiles


def read(ctx):
    if not ctx.step_times:
        return None
    return step_percentiles(ctx.step_times)["p50_ms"]
