"""The program's ``facade.host_syncs`` counter (every device-to-host read)
over the facade's steps, in the window before the profiled slice."""

from ccbench.program_trace import before_slice


def read(run):
    w = before_slice(run)
    if w is None or "facade.host_syncs" not in w["counts"]:
        return None
    return w["counts"]["facade.host_syncs"] / w["steps"]
