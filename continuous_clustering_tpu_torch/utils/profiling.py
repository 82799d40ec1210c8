"""Device profiling helpers (the port's counterpart of
``continuous_clustering_tpu/utils/profiling.py``).

Wrap any streaming section in ``trace()`` to record host and CUDA activity
with ``torch.profiler`` and write a Chrome trace (open it in
``chrome://tracing`` or Perfetto).  ``span()`` is a span of the program's
registry (``utils/stats.TRACE``): while a profiler records, it opens a
``record_function`` of its name, so the program's layers (``facade.*``,
``step.*``, ``node.*``) line up with the device timeline on their own.
"""

from __future__ import annotations

import contextlib
import os

from .stats import TRACE


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


def span(name: str, device=None):
    """A span of the program's registry: recorded always, a named range on
    the profiler's timeline while one records."""
    return TRACE.span(name, device)
