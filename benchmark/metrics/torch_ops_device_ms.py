"""Device ms a step of every other device operation in the traced unit:
PyTorch's kernels, copies and sets (the step phases, the fused pass's
binning and gathers, the clearance gate)."""

from ..trace import is_csrc


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds(lambda name: not is_csrc(name))
    if s <= 0:
        return None
    return 1e3 * s / t.steps
