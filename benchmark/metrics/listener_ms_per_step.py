"""ms a step spent inside the application's EventListener callbacks
(benchmark-side spans around each callback's body) over the measured
window."""


def read(ctx):
    if ctx.listener_s is None or not ctx.window_steps:
        return None
    return 1e3 * ctx.listener_s / ctx.window_steps
