"""K2 ``window_cc``: the sum over its launches in the profiled slice of
the least time for that launch's own rounds (frozen
``bounds.kernel_bounds``) over the sum of their device times, in %."""


def read(run):
    t = run.trace
    return t.roofline_pct.get("window_cc") if t is not None else None
