"""ms a step of the spawn clearance gate on the device: the interval
between the CUDA events that open and close the program's
``crowdsim.step.spawn_gate`` span (around ``spawn_blocked``), summed over
the traced unit, over its steps.  The interval is the gate's own device
time while the host runs ahead of the device, as it does at the gate,
which is queued before the step's one host read."""

from . import _spans


def read(ctx):
    n = _spans.steps(ctx)
    gates = _spans.spans("crowdsim.step.spawn_gate")
    if n is None or not gates or any(r.device_ms is None for r in gates):
        return None
    return sum(r.device_ms for r in gates) / n
