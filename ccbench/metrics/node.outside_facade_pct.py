"""Share of the traced window, up to the profiled slice, that the node
spends outside its facade's ``add_firing`` (decode, transform sync, the
per-firing host path): spans the node driver records around the facade's
public call."""


def read(run):
    w = run.window
    if "inside_facade_s" not in w or w["spans_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["inside_facade_s"] / w["spans_window_s"])
