"""The port's layers in one cell of the benchmark, on the card: one run of
the cell's window (and, with ``--trace 1``, its profiled slice) through the
benchmark's own driver, without the reference check, and what the
program's registry (``continuous_clustering_tpu_torch/utils/stats.TRACE``)
and the profile say of it.

    python3 scripts/trace_layers.py --workload <cell> --seed <n> \
        [--seconds 30] [--trace 0|1] [--enable]

``--enable`` turns the registry's device times on for the window
(``TRACE.enable()``: a ``record_function`` per span and CUDA events around
the step layers) without a profiler, which is how the cost of tracing when
on is measured.  Prints one JSON line:

* ``points_per_s`` (the benchmark's definition) and, in the paced cell, the
  publish p50/p95;
* ``before_slice`` (with ``--trace 1``: the steps before the profiled
  slice) or ``window``: per facade step, each span's total and self ms
  (``layers``; its device ms where recorded) and the counters
  (``per_step``; with ``node.host_ms_per_rev`` in the node cell);
* ``cover``: over the same part of the window, the share of ``add_firing``'s
  host time inside ``facade.batch``, and inside the spans directly under it;
* ``alloc_segments_grown``: the allocator's segments allocated over the window;
* with ``--trace 1``: ``kernels_per_step``, ``idle_pct``, the profile's
  longest idle gaps, each named by the innermost program span covering its
  middle (with the chain of spans above it) and the host op under it, and
  the device-side copies of the program's ranges (``device_annotations``)
  with those not marked as annotations (``unmarked``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GAPS = 12


def segments(torch, dev) -> int:
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


def name_gaps(prof, lo, hi, top):
    """The ``top`` longest device-idle gaps of the slice, each named by the
    innermost user span covering its middle."""
    from ccbench.trace import SLICE_SPAN, _busy_and_gaps, _events

    evs = _events(prof)
    spans = [e for e in evs if not e[1] and e[2] and e[0] != SLICE_SPAN]
    ops = [e for e in evs if not e[1] and not e[2]]
    dev = [e for e in evs if e[1] and not e[2]]
    dev = [e for e in dev if e[4] > lo and e[3] < hi]
    _, gaps = _busy_and_gaps(dev, lo, hi)
    out = []
    for g in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (g[0] + g[1]) // 2
        cover = sorted((e for e in spans if e[3] <= mid < e[4]), key=lambda e: (e[3], -e[4]))
        under = [e for e in ops if e[3] <= mid < e[4]]
        op = max(under, key=lambda e: e[3])[0] if under else "no host op"
        out.append({"ms": (g[1] - g[0]) / 1e6,
                    "span": cover[-1][0] if cover else "no span",
                    "chain": "/".join(e[0] for e in cover), "op": op})
    names = {e[0] for e in spans}
    marked = [e for e in evs if e[1] and e[2]]
    unmarked = [e for e in evs if e[1] and not e[2] and e[0] in names]
    return out, len(marked), len(unmarked)


def per_step(w, columns):
    steps = w["steps"] or 1
    layers = {n: {"ms": s["total_ns"] / 1e6 / steps, "self_ms": s["self_ns"] / 1e6 / steps,
                  "count": s["count"] / steps} for n, s in sorted(w["spans"].items())}
    for n, d in w["device_ns"].items():
        layers.setdefault(n, {})["device_ms"] = d / 1e6 / steps
    counts = {n: c / steps for n, c in sorted(w["counts"].items())}
    if w["counts"].get("node.firings"):
        revs = w["counts"]["node.firings"] / columns
        counts["node.revolutions"] = revs
        node_ns = sum(s["self_ns"] for n, s in w["spans"].items() if n.startswith("node."))
        counts["node.host_ms_per_rev"] = node_ns / 1e6 / revs
    return {"steps": w["steps"], "layers": layers, "per_step": counts}


def cover(trace, calls, lo, hi):
    """Shares of add_firing's host time in [lo, hi) inside facade.batch and
    inside the spans directly under facade.batch."""
    spans = trace.spans()
    batch = {sid: t1 - t0 for name, sid, _, _, t0, t1 in spans
             if name == "facade.batch" and lo <= t0 < hi}
    under = sum(t1 - t0 for name, _, parent, _, t0, t1 in spans if parent in batch)
    add = sum(t1 - t0 for t0, t1 in calls if lo <= t0 < hi)
    if not add or not batch:
        return None
    return {"add_firing_ms": add / 1e6, "batch_of_add_firing": sum(batch.values()) / add,
            "named_of_add_firing": under / add,
            "named_of_batch": under / sum(batch.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--enable", action="store_true")
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at --trace 0")
    args = p.parse_args(argv)

    import torch

    from ccbench import harness
    from ccbench import trace as bench_trace

    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("trace_layers: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    port = harness.import_program()
    stats = importlib.import_module(f"{harness.PROGRAM}.utils.stats")
    reg = stats.TRACE
    drv = importlib.import_module(f"ccbench.drivers.{cell.traffic['driver']}").Driver(
        port, cell.config, cell.traffic, args.seed % (1 << 64), dev)

    # every add_firing call's host interval, whichever driver calls it
    calls = []
    cls = port.continuous_clustering.ContinuousClustering
    orig_add = cls.add_firing
    clock = time.perf_counter_ns

    def add_firing(self, firing, pose):
        t0 = clock()
        orig_add(self, firing, pose)
        calls.append((t0, clock()))

    cls.add_firing = add_firing
    kept = {}
    orig_summary = bench_trace.Slice.summary

    def summary(self):
        kept["slice"] = self
        return orig_summary(self)

    bench_trace.Slice.summary = summary

    if args.trace:
        bench_trace.warm_profiler()
    drv.setup()
    tracer = None
    if args.trace:
        t = cell.traffic["trace"]
        cl = cell.config["pipeline"].get("clustering", {})
        tracer = bench_trace.Slice(t["steps"], min(t["start_s"], 0.75 * args.seconds),
                                   time.perf_counter(), port.cc_cuda,
                                   cl.get("max_steps_in_row", 20),
                                   cl.get("max_steps_in_column", 20))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seg0 = segments(torch, dev)
    calls.clear()
    if args.enable:
        reg.enable()
    t_win = clock()
    window = drv.window(args.seconds, tracer)
    seg1 = segments(torch, dev)
    if args.enable:
        reg.disable()
    snap = reg.snapshot()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"workload": args.workload, "seed": args.seed, "enable": args.enable,
           "trace": args.trace, "device": name,
           "window_s": window["window_s"], "n_steps": window["n_steps"],
           "alloc_segments_grown": seg1 - seg0,
           "registry_alloc_segments_grown": snap.get("alloc_segments_grown"),
           "launches": snap["launches"]}
    if window.get("points"):
        out["points_per_s"] = window["points"] / window["window_s"]
    if cell.traffic["loop"] == "open" and window.get("latency_ms"):
        from ccbench.frozen.latency import percentiles

        out["publish"] = percentiles(window["latency_ms"])
    columns = cell.config["sensor"]["columns"]
    if tracer is not None:
        tracer.close(window["n_steps"])
        rec = tracer.summary()
        hi = reg.profiler_started_ns
        lo = hi - int(min(cell.traffic["trace"]["start_s"], 0.75 * window["window_s"]) * 1e9)
        out["before_slice"] = per_step(reg.window(lo, hi), columns)
        out["cover"] = cover(reg, calls, lo, hi)
        if "inside_facade_s" in window:
            out["node_outside_facade_pct"] = 100.0 * (
                1.0 - window["inside_facade_s"] / window["spans_window_s"])
        if rec is not None:
            sl = kept["slice"]
            evs = bench_trace._events(sl.prof)
            mark = [e for e in evs if e[0] == bench_trace.SLICE_SPAN and not e[1]]
            gaps, marked, unmarked = name_gaps(sl.prof, mark[0][3], mark[0][4], GAPS)
            out.update(kernels_per_step=rec.kernels / rec.steps if rec.steps else None,
                       idle_pct=100.0 * (1.0 - rec.busy_s / rec.window_s),
                       roofline_pct=rec.roofline_pct, slice_steps=rec.steps,
                       gaps=gaps, device_annotations=marked, unmarked=unmarked,
                       bench_gaps=rec.idle_gaps[:5])
    else:
        out["window"] = per_step(reg.window(t_win), columns)
        out["cover"] = cover(reg, calls, t_win, clock())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
