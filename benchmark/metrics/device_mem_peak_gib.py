"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2.0 ** 30
