"""One run of one cell: the cell's configuration, traffic and metrics are
found by name from ``BENCHMARK.json``; the traffic file names its driver
(``drivers/<driver>.py``), each metric has a reader (``metrics/<name>.py``)
and each cell its limits (``limits/<cell>.json``).  Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none.

A run: set-up (the program, the scene, the warm-up revolutions), the
measured window, the profiled slice where ``--trace 1``, then the late
answers (a flush), the program's last revolution read back, the program
freed, the reference, and the comparison that decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "continuous_clustering_tpu")
PROGRAM = "continuous_clustering_tpu_torch"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = spec if spec is not None else _load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name, chips=w["chips"],
        config=_load_json(ROOT / configs[w["config"]]["file"]),
        traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        limits=_load_json(HERE / "limits" / f"{name}.json"),
    )


def reader(metric: str):
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ccbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def import_program() -> types.SimpleNamespace:
    """The entry points of the program under test."""
    sub = {"config": "config", "continuous_clustering": "models.continuous_clustering",
           "node": "io.node", "cc_cuda": "ops.cc_cuda"}
    return types.SimpleNamespace(**{k: importlib.import_module(f"{PROGRAM}.{v}")
                                    for k, v in sub.items()})


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window: Dict
    trace: Optional[object]


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` gives it."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return smi.stdout.strip() or None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """One run; returns the result line's fields and the numbers compared."""
    import torch

    from .check import compare, judge
    from .reference.steady import steady_revolution

    port = import_program()
    cuda = device.type == "cuda"
    seed_np = seed % (1 << 64)
    drv = importlib.import_module(f"ccbench.drivers.{cell.traffic['driver']}").Driver(
        port, cell.config, cell.traffic, seed_np, device)
    if trace and cuda:
        from .trace import warm_profiler

        warm_profiler()
    drv.setup()
    setup_s = time.time() - t_start
    tracer = None
    if trace:
        from .trace import Slice

        cl = cell.config["pipeline"].get("clustering", {})
        t = cell.traffic["trace"]
        tracer = Slice(t["steps"], min(t["start_s"], 0.75 * seconds), time.perf_counter(),
                       port.cc_cuda, cl.get("max_steps_in_row", 20),
                       cl.get("max_steps_in_column", 20))
    window = drv.window(seconds, tracer)
    record = None
    if tracer is not None:
        tracer.close(window["n_steps"])
        record = tracer.summary()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    run = Run(cell, setup_s, window, record)
    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_finish = time.perf_counter()
    clusters, cols, revolutions = drv.finish()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = steady_revolution(cell.config["pipeline"], cell.config["sensor"]["rows"],
                            drv.reference_firing, drv.ego)
    t_cmp = time.perf_counter()
    res = compare(ref, clusters, cols, revolutions, drv.rev_ns, drv.uidx_per_rev)
    numbers = res["numbers"]
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": peak}
    if record is not None:
        device_info.update(busy_s=record.busy_s, window_s=record.window_s)
    if cuda:
        device_info["power_limit"] = power_limit()
    out = {"correct": judge(numbers, cell.limits), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device_info}
    if record is not None:
        out["breakdown"] = {"device_ops": [list(x) for x in record.device_ops],
                            "idle_gaps": [list(x) for x in record.idle_gaps]}
    out["checks"] = {n: {"value": numbers[n], "limit": cell.limits.get(n)} for n in numbers}
    out["_window"] = {k: v for k, v in window.items() if not isinstance(v, list)}
    out["_window"].update(revolutions_compared=len(revolutions), finish_s=t_ref - t_finish,
                          reference_s=t_cmp - t_ref, compare_s=time.perf_counter() - t_cmp)
    return out
