"""The program's own spans and counters (its registry,
``continuous_clustering_tpu_torch/utils/stats.py::TRACE``) over the part of
the traced window before the profiled slice: the steps that began in the
``trace.start_s`` seconds before the program saw the profiler start, and
ended before it.  None where the program has no such registry, or the
registry holds no such step."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

REGISTRY = "continuous_clustering_tpu_torch.utils.stats"


def before_slice(run) -> Optional[Dict]:
    """The registry's ``window`` over those steps."""
    try:
        reg = getattr(importlib.import_module(REGISTRY), "TRACE", None)
    except ImportError:
        return None
    hi = getattr(reg, "profiler_started_ns", None)
    if hi is None:
        return None
    start_s = min(run.cell.traffic["trace"]["start_s"], 0.75 * run.window["window_s"])
    w = reg.window(hi - int(start_s * 1e9), hi)
    return w if w["steps"] else None


def span_ms_per_step(run, name: str, key: str = "total_ns") -> Optional[float]:
    """``key`` (``total_ns`` or ``self_ns``) of the spans ``name`` over the
    facade's steps, in ms."""
    w = before_slice(run)
    if w is None or name not in w["spans"]:
        return None
    return w["spans"][name][key] / 1e6 / w["steps"]
