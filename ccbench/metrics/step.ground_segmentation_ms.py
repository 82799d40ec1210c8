"""Self time of the program's ``step.ground_segmentation`` spans over the
facade's steps, in the window before the profiled slice (host clock: the
enqueue of ground segmentation's ops, which the card runs behind it)."""

from ccbench.program_trace import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "step.ground_segmentation", "self_ns")
