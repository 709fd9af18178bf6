"""K1's share of its roofline, %: the least time of its work
(``yardstick.k1_bytes``/``k1_work`` at 3.35 TB/s and 67 TFLOP/s f32),
averaged over the inputs of the steps that the check compares (three of
the traced episode's steps, which every episode passes through bit for
bit), over K1's mean device time a launch over all of the traced
episode's steps."""

from ..trace import K1_KERNEL


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.k1_bound_ms:
        return None
    times = [s for name, s, _ in t.ops if K1_KERNEL in name]
    if not times:
        return None
    return 100.0 * ctx.k1_bound_ms / (1e3 * sum(times) / len(times))
