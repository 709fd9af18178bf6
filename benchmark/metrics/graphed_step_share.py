"""Share of the traced unit's steps replayed from CUDA graphs: the
program's ``crowdsim.graphed_steps`` counter (a step whose halves before
and after its read were both graph replays) over the traced unit's
steps.  None where the program keeps no such counter, or counted none
(a CPU run, or a program that issues every step eagerly)."""

from . import _spans


def read(ctx):
    n = _spans.steps(ctx)
    total = _spans.counter("crowdsim.graphed_steps")
    if n is None or total is None:
        return None
    return total / n
