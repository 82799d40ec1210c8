"""Share of the profiled slice in which no operation ran on the device
(the union of the profiler's device activity, against the slice's
host-clock length)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
