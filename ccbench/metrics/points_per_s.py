"""Points the pipeline finished in the window, per second of the window:
the finite points of every column it published (its first unpublished
column moved from where it stood when the window opened to where it stood
when it closed, the card synchronised), over the whole window."""


def read(run):
    w = run.window
    return w["points"] / w["window_s"] if w.get("points") else None
