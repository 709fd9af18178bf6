"""Re-sorts of the state a step: the program's ``crowdsim.resorts``
counter (the skin's host decision to re-sort, or the presort of a step
without the skin) over the traced unit's steps."""

from . import _spans


def read(ctx):
    n = _spans.steps(ctx)
    total = _spans.counter("crowdsim.resorts")
    if n is None or total is None:
        return None
    return total / n
