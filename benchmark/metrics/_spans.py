"""The program's own spans and counters: the store of
``rmf_crowdsim_tpu_torch.utils.profiling``, filled while the traced unit
ran under the profiler (and only then: the span and the counter are on
exactly while a profiler session is active).  A program without that
store reads as empty, so each reader returns None there."""

from rmf_crowdsim_tpu_torch.utils import profiling


def spans(*names):
    """The closed spans named ``names``, in the order they opened; none
    where the store dropped spans past its bound (it holds part of the
    unit only)."""
    records = getattr(profiling, "records", None)
    if records is None or counter(getattr(profiling, "DROPPED", "")):
        return []
    return [r for r in records() if r.name in names and r.t1_ns]


def counter(name):
    """The counter's total, or None where it was never counted."""
    counters = getattr(profiling, "counters", None)
    return None if counters is None else counters().get(name)


def steps(ctx):
    """The traced unit's steps, or None without a traced unit."""
    t = ctx.trace
    return t.steps if t is not None and t.steps else None
