"""K1 ``edge_bits``: the sum over its launches in the profiled slice of
the least time the H100 could take for that launch's own inputs (frozen
``bounds.kernel_bounds``) over the sum of their device times, in %."""


def read(run):
    t = run.trace
    return t.roofline_pct.get("edge_bits") if t is not None else None
