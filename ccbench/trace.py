"""The traced run's profile: ``torch.profiler`` over a bounded slice of the
window, a few of the facade's steps, never the whole window, and no trace
file written.

The slice starts ``start_s`` into the window (late, so that the readings
taken from the window's spans before it are many), after a
synchronisation, and stops once the facade has run ``steps`` more steps
(its ``n_steps`` counter), after another.  While it runs, the drivers record spans of their
own around their calls into the program (``span``), and the launches of K1
(``edge_bits``) and K2 (``window_cc``) keep their inputs, so that each
launch's least time (``frozen/bounds.py``) can be set beside its device
time.  ``summary`` reduces the profile to what the per-layer readers and
the result line's ``breakdown`` read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import types
from typing import Dict, List, Optional, Tuple

from .frozen.bounds import kernel_bounds

_NULL = contextlib.nullcontext()
SLICE_SPAN = "ccbench.slice"
KERNEL_SYMBOLS = {"edge_bits": "edge_bits_kernel", "window_cc": "window_cc_kernel"}
TOP = 10


@dataclasses.dataclass
class TraceRecord:
    busy_s: float                 # device busy time in the slice (union of device ops)
    window_s: float               # the slice's host-clock length
    steps: int                    # facade steps in the slice
    kernels: int                  # device kernels in the slice (no copies or fills)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    roofline_pct: Dict[str, Optional[float]]


def warm_profiler() -> None:
    """Start and stop the profiler once on a trivial launch: its first
    start loads the device tracer, which takes seconds, and must not fall
    into the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Slice:
    def __init__(self, steps: int, start_s: float, window_t0: float, cc_cuda, H: int, V: int):
        self.steps, self.t_start = steps, window_t0 + start_s
        self.cc_cuda, self.H, self.V = cc_cuda, H, V
        self.state = "wait"
        self.span_names = {SLICE_SPAN}
        self.launches: Dict[str, list] = {"edge_bits": [], "window_cc": []}

    # ----------------------------------------------------------- in the window
    def span(self, name: str):
        if self.state != "on":
            return _NULL
        import torch

        self.span_names.add(name)
        return torch.profiler.record_function(name)

    def poll(self, now: float, n_steps: int) -> None:
        if self.state == "wait" and now >= self.t_start:
            self._begin(n_steps)
        elif self.state == "on" and n_steps - self.n0 >= self.steps:
            self._end(n_steps)

    def close(self, n_steps: int) -> None:
        """The window is over: end a slice still running."""
        if self.state == "on":
            self._end(n_steps)

    def _begin(self, n_steps: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.slice_span = record_function(SLICE_SPAN)
        self.slice_span.__enter__()
        self._patch()
        self.n0, self.t0 = n_steps, time.perf_counter()
        self.state = "on"

    def _end(self, n_steps: int) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1, self.n1 = time.perf_counter(), n_steps
        self._unpatch()
        self.slice_span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.state = "done"

    def _patch(self) -> None:
        cc = self.cc_cuda
        self._orig = (cc.edge_bits_stacked, cc.window_cc_stacked)
        eb, wc = self._orig
        k1, k2 = self.launches["edge_bits"], self.launches["window_cc"]

        def edge_bits_stacked(xw, yw, zw, incw, active_w, mad, wp, **kw):
            bits = eb(xw, yw, zw, incw, active_w, mad, wp, **kw)
            k1.append((active_w, wp, bits))
            return bits

        def window_cc_stacked(bits, L0, max_wp, **kw):
            out = wc(bits, L0, max_wp, **kw)
            k2.append((max_wp, out[2]))
            return out

        cc.edge_bits_stacked, cc.window_cc_stacked = edge_bits_stacked, window_cc_stacked

    def _unpatch(self) -> None:
        self.cc_cuda.edge_bits_stacked, self.cc_cuda.window_cc_stacked = self._orig

    # ------------------------------------------------------------ afterwards
    def summary(self) -> Optional[TraceRecord]:
        if self.state != "done":
            return None
        evs = _events(self.prof)
        # the device's copies of the host spans are no device work
        dev = [e for e in evs if e[1] and not e[2] and e[0] not in self.span_names]
        cpu = [e for e in evs if not e[1]]
        spans = [e for e in cpu if e[2]]
        ops = [e for e in cpu if not e[2]]
        sl = [e for e in spans if e[0] == SLICE_SPAN]
        lo = sl[0][3] if sl else min((e[3] for e in dev), default=0)
        hi = sl[0][4] if sl else max((e[4] for e in dev), default=0)
        dev = [e for e in dev if e[4] > lo and e[3] < hi]
        busy_ns, gaps = _busy_and_gaps(dev, lo, hi)
        kernels = [e for e in dev if not e[0].startswith(("Memcpy", "Memset"))]
        per_name: Dict[str, float] = {}
        for e in dev:
            per_name[e[0]] = per_name.get(e[0], 0.0) + (e[4] - e[3]) / 1e9
        device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = [(_name_gap(g, spans, ops), (g[1] - g[0]) / 1e9) for g in gaps]
        return TraceRecord(
            busy_s=busy_ns / 1e9, window_s=self.t1 - self.t0, steps=self.n1 - self.n0,
            kernels=len(kernels), device_ops=[(n[:120], s) for n, s in device_ops],
            idle_gaps=named, roofline_pct=self._rooflines(kernels))

    def _rooflines(self, kernels) -> Dict[str, Optional[float]]:
        """Per kernel: the sum of its launches' least times over the sum of
        their device times, in %; None where the profile and the launches
        kept do not pair up one to one."""
        k1, k2 = self.launches["edge_bits"], self.launches["window_cc"]
        out: Dict[str, Optional[float]] = {"edge_bits": None, "window_cc": None}
        if not k1 or len(k1) != len(k2):
            return out
        bounds = {"edge_bits": 0.0, "window_cc": 0.0}
        for (active_w, wp, bits), (max_wp, rounds) in zip(k1, k2):
            for s in range(active_w.shape[0]):
                win = types.SimpleNamespace(active_w=active_w[s], wp=wp[s])
                b = kernel_bounds(win, bits[s], int(max_wp[s]), int(rounds[s]), self.H, self.V)
                for name in bounds:
                    bounds[name] += b[name]["bound_ms"]
        for name, symbol in KERNEL_SYMBOLS.items():
            times = [(e[4] - e[3]) / 1e6 for e in kernels if symbol in e[0]]
            if len(times) == len(k1) and sum(times) > 0:
                out[name] = 100.0 * bounds[name] / sum(times)
        return out


def _events(prof) -> List[Tuple[str, bool, bool, int, int]]:
    """(name, on the device, a user span, start ns, end ns) of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            start = e.start_ns()
            out.append((e.name(), e.device_type() == cuda, bool(e.is_user_annotation()),
                        start, start + e.duration_ns()))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == cuda, bool(getattr(e, "is_user_annotation", False)),
                    int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)))
    return out


def _busy_and_gaps(dev, lo: int, hi: int):
    """Device-busy ns in [lo, hi] (the union of the device ops) and the idle
    gaps between them as (start, end)."""
    iv = sorted((max(e[3], lo), min(e[4], hi)) for e in dev)
    busy, gaps, cur = 0, [], lo
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _name_gap(gap, spans, ops) -> str:
    """The benchmark span and the host operation that cover most of the
    gap, as ``span>op``."""

    def most(evs):
        cover: Dict[str, int] = {}
        for e in evs:
            if e[0] != SLICE_SPAN and e[3] < gap[1] and e[4] > gap[0]:
                cover[e[0]] = cover.get(e[0], 0) + min(e[4], gap[1]) - max(e[3], gap[0])
        return max(cover, key=cover.get) if cover else None

    span, op = most(spans), most(ops)
    return f"{span or 'no span'}>{op or 'no host op'}"[:120]
