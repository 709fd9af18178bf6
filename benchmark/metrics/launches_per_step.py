"""Kernel launches a step: the host's ``cudaLaunchKernel`` calls in the
traced unit over its steps.  The harness prints the device's kernel
records beside it (the profiler has been seen to drop records)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.launches == 0:
        return None
    return t.launches / t.steps
