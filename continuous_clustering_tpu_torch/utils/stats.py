"""Observability: workload recording, stage timing, latency tracking (the
port's copy of ``continuous_clustering_tpu/utils/stats.py``).

Covers the reference's debug facilities (recordJobQueueWorkload,
src/clustering/continuous_clustering.cpp:1147-1159; per-sequence wall clock,
kitti_demo.cpp:421-437) plus what a device deployment needs: per-step
timing and end-to-end cluster-publish latency percentiles.

``StageTimer`` is also the program's tracing registry (``TRACE``): the
facade, the step, the node and the sensors record their layers' spans and
counters into it, and the helpers ``to_host``, ``host_bool`` and
``to_device`` count every copy between the host and the device.
``LAUNCHES`` counts the launches of each hand-written CUDA kernel.
"""

from __future__ import annotations

import itertools
import threading
import time
from array import array
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

_clock = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
# the ring's bounds: steps, spans in all (about 40 bytes each), spans of one
# record (a record that fills continues in a new one of the same step)
MAX_STEPS = 4096
MAX_SPANS = 1 << 19
RECORD_SPANS = 1 << 14


class WorkloadRecorder:
    """Queue-depth samples across pipeline stages (bounded like the
    reference's 100k-sample ring)."""

    def __init__(self, stages=("sensor", "fifo", "device", "publish"), max_samples=100_000):
        self.stages = stages
        self.samples: Deque[tuple] = deque(maxlen=max_samples)

    def record(self, **depths: int) -> None:
        self.samples.append(tuple(depths.get(s, 0) for s in self.stages))

    def summary(self) -> Dict[str, Dict[str, float]]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples, dtype=np.float64)
        return {
            s: {
                "mean": float(arr[:, i].mean()),
                "max": float(arr[:, i].max()),
                "p95": float(np.percentile(arr[:, i], 95)),
            }
            for i, s in enumerate(self.stages)
        }


class _Record:
    """One facade step's spans and counts: every span that began from the
    step's start until the next step's."""

    __slots__ = ("step", "t0", "names", "spans", "counts", "device_ns")

    def __init__(self, step: int, t0: int):
        self.step, self.t0 = step, t0
        self.names: List[str] = []
        self.spans = array("q")       # (id, parent id or -1, start ns, end ns) per span
        self.counts: Dict[str, int] = {}
        self.device_ns: Dict[str, int] = {}


class _Span:
    __slots__ = ("reg", "name", "device", "stack", "rec", "sid", "parent", "t0", "rf", "ev")

    def __init__(self, reg: "StageTimer", name: str, device):
        self.reg, self.name, self.device = reg, name, device

    def __enter__(self):
        reg = self.reg
        self.stack = stack = reg._stack()
        rec = reg._rec
        if len(rec.names) >= RECORD_SPANS:
            rec = reg._push(_Record(rec.step, _clock()))
        self.rec = rec
        self.sid = sid = next(reg._ids)
        self.parent = stack[-1] if stack else -1
        stack.append(sid)
        self.rf = self.ev = None
        prof = _profiler_enabled()
        if prof is not reg._profiler_seen:
            reg._profiler_edge(prof)
        if prof or reg._enabled:
            reg._open(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        reg = self.reg
        if self.rf is not None:
            reg._close(self)
        self.stack.pop()
        rec = self.rec
        rec.names.append(self.name)
        rec.spans.extend((self.sid, self.parent, self.t0, t1))
        reg._n_spans += 1


class StageTimer:
    """The port's tracing registry: named spans and counters, recorded where
    the work happens.

    A span (``span(name)``) records its name, its start and end on
    ``time.perf_counter_ns``, the span it opened under (per thread) and the
    facade step it began in.  Spans are kept in a bounded ring of per-step
    records (``step`` opens one; at most ``MAX_STEPS`` steps and about
    ``MAX_SPANS`` spans); ``window``/``snapshot`` reduce them to per-name
    totals and self times (a span's duration less what its children cover).
    A counter (``count``) adds to the open record.

    Off (no ``enable()``, no ``torch.profiler`` recording), a span costs two
    clock reads and an append, a counter an integer add.  While a profiler
    records, or after ``enable()``, each span also opens
    ``torch.profiler.record_function(<name>)``, so that it sits on the
    profiler's timeline over the device work it launched, and spans given a
    CUDA ``device`` record CUDA events at their edges (pooled); their device
    times are read without a synchronisation once the events are done
    (``resolve``, after the facade's meta read), or at a snapshot.

    ``track(name)`` is the lifetime total of a named stage (``summary()``),
    without the ring: the facade's ``stats`` keeps ``device_step`` and
    ``host_batch_prep`` so."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._ring: Deque[_Record] = deque()
        self._ids = itertools.count()
        self._tls = threading.local()
        self._enabled = False
        self._profiler_seen = False
        # perf_counter_ns when the registry last saw a profiler start recording
        self.profiler_started_ns: Optional[int] = None
        self._segments0: Optional[int] = None
        self._pending: Deque[tuple] = deque()
        self._events: Dict[object, list] = {}
        self.clear()

    def clear(self) -> None:
        """Drop every record: the ring starts anew (step -1 until the next
        ``step``); device times still pending are dropped with it."""
        self._ring.clear()
        self._pending.clear()
        self._n_spans = 0
        self._rec = self._push(_Record(-1, _clock()))

    # ------------------------------------------------------------- legacy
    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.name] = self.timer.totals.get(self.name, 0.0) + dt
            self.timer.counts[self.name] = self.timer.counts.get(self.name, 0) + 1

    def track(self, name: str) -> "StageTimer._Ctx":
        return self._Ctx(self, name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> total_s, count, mean_ms: the tracked stages over the
        timer's life, the spans over the ring."""
        tot = dict(self.totals)
        cnt = dict(self.counts)
        for name, s in self.window(self._ring[0].t0)["spans"].items():
            tot[name] = tot.get(name, 0.0) + s["total_ns"] / 1e9
            cnt[name] = cnt.get(name, 0) + s["count"]
        return {
            k: {"total_s": v, "count": cnt[k], "mean_ms": 1e3 * v / cnt[k]}
            for k, v in tot.items() if cnt[k]
        }

    # -------------------------------------------------------------- record
    def span(self, name: str, device=None) -> _Span:
        """A span named ``name`` around a ``with`` block; ``device`` (a
        ``torch.device``) marks a step layer whose device time is recorded
        while tracing is on."""
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1) -> None:
        c = self._rec.counts
        c[name] = c.get(name, 0) + n

    def step(self, step_id: int) -> None:
        """Open the record of facade step ``step_id``: the spans that begin
        from now until the next step belong to it."""
        rec = self._push(_Record(step_id, _clock()))
        rec.counts["facade.steps"] = 1
        if self._pending:
            self.resolve()

    def enable(self) -> None:
        """Record functions and device times without a profiler, from now
        until ``disable``; a new session for the allocator's growth."""
        self._enabled = True
        self._begin_session()

    def disable(self) -> None:
        self._enabled = False

    def resolve(self) -> None:
        """Device times of the step layers whose end events have completed,
        in order; reads no event still pending."""
        pend = self._pending
        while pend:
            rec, name, e0, e1, dev = pend[0]
            if not e1.query():
                return
            pend.popleft()
            rec.device_ns[name] = rec.device_ns.get(name, 0) + int(e0.elapsed_time(e1) * 1e6)
            self._events[dev] += [e0, e1]

    # ------------------------------------------------------------- read
    def window(self, lo_ns: int, hi_ns: Optional[int] = None) -> Dict:
        """Totals over the records of the steps that began at or after
        ``lo_ns`` and ended (the next step began) by ``hi_ns`` (None: up to
        now, the open step included): ``steps`` (``facade.steps``),
        ``spans`` (name -> total_ns, self_ns, count), ``counts`` (name ->
        total) and ``device_ns`` (name -> device time, where recorded)."""
        ring = list(self._ring)
        ends = [r.t0 for r in ring[1:]] + [None]
        recs = [r for r, end in zip(ring, ends) if r.t0 >= lo_ns
                and (hi_ns is None or (end is not None and end <= hi_ns))]
        # a child may begin in a later record than its parent: their cover
        # is summed over the whole ring
        cover: Dict[int, int] = {}
        for r in ring:
            s = r.spans
            for i in range(0, len(s), 4):
                if s[i + 1] >= 0:
                    cover[s[i + 1]] = cover.get(s[i + 1], 0) + s[i + 3] - s[i + 2]
        spans: Dict[str, Dict[str, int]] = {}
        counts: Dict[str, int] = {}
        device: Dict[str, int] = {}
        for r in recs:
            s = r.spans
            for k, name in enumerate(r.names):
                d = s[4 * k + 3] - s[4 * k + 2]
                e = spans.setdefault(name, {"total_ns": 0, "self_ns": 0, "count": 0})
                e["total_ns"] += d
                e["self_ns"] += d - cover.get(s[4 * k], 0)
                e["count"] += 1
            for name, n in r.counts.items():
                counts[name] = counts.get(name, 0) + n
            for name, n in r.device_ns.items():
                device[name] = device.get(name, 0) + n
        return {"steps": counts.get("facade.steps", 0), "records": len(recs), "spans": spans,
                "counts": counts, "device_ns": device}

    def snapshot(self) -> Dict:
        """``window`` over the whole ring, every pending device time read
        (a synchronisation), with the kernel launch counters and the growth
        of the allocator's segments since the session began."""
        for _, _, _, e1, _ in self._pending:
            e1.synchronize()
        self.resolve()
        out = self.window(self._ring[0].t0)
        out["launches"] = dict(LAUNCHES)
        seg = _segments()
        if seg is not None and self._segments0 is not None:
            out["alloc_segments_grown"] = seg - self._segments0
        return out

    def spans(self) -> List[Tuple[str, int, int, int, int, int]]:
        """Every span in the ring as (name, id, parent id, step, start ns,
        end ns)."""
        out = []
        for r in self._ring:
            s = r.spans
            out += [(name, s[4 * k], s[4 * k + 1], r.step, s[4 * k + 2], s[4 * k + 3])
                    for k, name in enumerate(r.names)]
        return out

    # ---------------------------------------------------------- internals
    def _stack(self) -> List[int]:
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = []
            return self._tls.stack

    def _push(self, rec: _Record) -> _Record:
        ring = self._ring
        ring.append(rec)
        self._rec = rec
        while len(ring) > 1 and (len(ring) > MAX_STEPS or self._n_spans > MAX_SPANS):
            self._n_spans -= len(ring.popleft().names)
        return rec

    def _profiler_edge(self, recording: bool) -> None:
        self._profiler_seen = recording
        if recording:
            self.profiler_started_ns = _clock()
            self._begin_session()

    def _open(self, sp: _Span) -> None:
        sp.rf = torch.profiler.record_function(sp.name)
        sp.rf.__enter__()
        dev = sp.device
        if dev is not None and dev.type == "cuda":
            sp.ev = self._event(dev)
            sp.ev.record(torch.cuda.current_stream(dev))

    def _close(self, sp: _Span) -> None:
        if sp.ev is not None:
            e1 = self._event(sp.device)
            e1.record(torch.cuda.current_stream(sp.device))
            self._pending.append((sp.rec, sp.name, sp.ev, e1, sp.device))
        sp.rf.__exit__(None, None, None)

    def _event(self, dev):
        pool = self._events.setdefault(dev, [])
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _begin_session(self) -> None:
        self._segments0 = _segments()


def _segments() -> Optional[int]:
    """The CUDA caching allocator's segments allocated so far (None before
    CUDA is initialised)."""
    if not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_stats().get("segment.all.allocated", 0))


# The process's registry: every span and counter of the program.
TRACE = StageTimer()

# Launches of the port's hand-written CUDA kernels, by kernel: each kernel's
# wrapper adds one per launch; the plain twins count nothing.
LAUNCHES = {"edge_bits": 0, "window_cc": 0, "ground_segment": 0, "sweep_probe": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: a device-to-host read, counted with its bytes
    (``facade.host_syncs``, ``facade.host_sync_bytes``)."""
    TRACE.count("facade.host_syncs")
    TRACE.count("facade.host_sync_bytes", t.numel() * t.element_size())
    return t.cpu()


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)`` of a one-element tensor: a device-to-host read, counted."""
    TRACE.count("facade.host_syncs")
    TRACE.count("facade.host_sync_bytes", t.element_size())
    return bool(t)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` (an array, a scalar or a host tensor; cast to
    ``dtype`` on the host) on ``device``: a host-to-device copy, counted with
    its bytes (``facade.uploads``, ``facade.upload_bytes``)."""
    t = torch.as_tensor(a, dtype=dtype)
    TRACE.count("facade.uploads")
    TRACE.count("facade.upload_bytes", t.numel() * t.element_size())
    return t.to(device, copy=True)


class LatencyTracker:
    """Cluster-publish latency w.r.t. the newest point stamp in the cluster
    (the reference's headline ~5 ms metric, README.md:11)."""

    def __init__(self, max_samples: int = 100_000):
        self.samples: Deque[float] = deque(maxlen=max_samples)

    def record_cluster(self, max_point_stamp_ns: int, wall_publish_ns: Optional[int] = None):
        now = wall_publish_ns if wall_publish_ns is not None else time.time_ns()
        self.samples.append((now - max_point_stamp_ns) / 1e6)  # ms

    def percentiles(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
        }
