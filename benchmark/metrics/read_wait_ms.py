"""ms a step that the host waits at the program's reads of the device:
the host time inside the ``crowdsim.step.read`` spans (the skin
decision's ``.item()``) and ``crowdsim.session.read`` spans (a session
step's one fetch), summed over the traced unit, over its steps."""

from . import _spans


def read(ctx):
    n = _spans.steps(ctx)
    reads = _spans.spans("crowdsim.step.read", "crowdsim.session.read")
    if n is None or not reads:
        return None
    return sum(r.host_ms for r in reads) / n
