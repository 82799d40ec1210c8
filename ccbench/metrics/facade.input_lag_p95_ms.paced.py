"""95th percentile over every column of the window before the profiled
slice of how late ``add_firing`` took it after its scheduled slot
(back-pressure at the entry point; the profiler's own stalls left out)."""

import numpy as np


def read(run):
    lags = run.window.get("input_lag_ms")
    return float(np.percentile(lags, 95)) if lags else None
