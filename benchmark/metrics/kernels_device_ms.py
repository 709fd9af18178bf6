"""Device ms a step of the program's own CUDA kernels (csrc/: K1, K1b,
K2, K3, K4, by kernel name) in the traced unit."""

from ..trace import is_csrc


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds(is_csrc)
    if s <= 0:
        return None
    return 1e3 * s / t.steps
