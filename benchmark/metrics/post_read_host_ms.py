"""ms a step of the host's launching after the step's read, which the device
waits on: for each step, the host time from the end of its
``crowdsim.step.read`` span to the end of its ``crowdsim.rollout.record``
span, summed over the traced unit, over its steps."""

from . import _spans


def read(ctx):
    n = _spans.steps(ctx)
    if n is None:
        return None
    read_end = {r.step: r.t1_ns for r in _spans.spans("crowdsim.step.read")}
    rec_end = {r.step: r.t1_ns
               for r in _spans.spans("crowdsim.rollout.record")}
    both = read_end.keys() & rec_end.keys()
    if not both:
        return None
    return sum(rec_end[k] - read_end[k] for k in both) * 1e-6 / n
