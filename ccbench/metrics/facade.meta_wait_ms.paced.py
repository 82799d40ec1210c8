"""Time of the program's ``facade.meta_wait`` spans (the blocking read of
each step's meta) over the facade's steps, in the window of the paced cell
before the profiled slice (host clock)."""

from ccbench.program_trace import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "facade.meta_wait")
