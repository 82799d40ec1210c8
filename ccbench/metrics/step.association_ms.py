"""Time of the program's ``step.association`` spans (its kernels' span
``step.association.cc`` included) over the facade's steps, in the window
before the profiled slice (host clock)."""

from ccbench.program_trace import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "step.association")
