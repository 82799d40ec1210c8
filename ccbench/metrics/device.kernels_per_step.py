"""Device kernels in the profiled slice over the facade's steps in it."""


def read(run):
    t = run.trace
    return t.kernels / t.steps if t is not None and t.steps else None
