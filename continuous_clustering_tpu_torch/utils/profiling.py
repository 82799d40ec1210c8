"""Device profiling helpers (the port's counterpart of
``continuous_clustering_tpu/utils/profiling.py``).

Wrap any streaming section in ``trace()`` to record host and CUDA activity
with ``torch.profiler`` and write a Chrome trace (open it in
``chrome://tracing`` or Perfetto); ``annotate()`` marks host-side stages so
they line up with the device timeline.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(logdir: str = "cct_trace"):
    """Record a ``torch.profiler`` trace around a block and export it as
    ``<logdir>/trace.json``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named host annotation visible in the trace timeline."""
    import torch

    return torch.profiler.record_function(name)
