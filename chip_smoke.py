#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, and builds the native host
   library and the CUDA kernels from this checkout (into
   ``continuous_clustering_tpu_torch/build/``);
2. drives the port's paths on the card: the facade
   (``ContinuousClustering.add_firing``) at the KITTI configuration (64 x
   2200, firing batch 384, 2 revolutions) with host insertion, then with
   device insertion; the sensor node (``launch.make_node``, the VLS-128 roof
   preset at 128 x 1700) from raw packets of 2 revolutions; the probe tool
   (``tools/sweep_probe.run``, every variant against its twin).  The
   kernels' launch counters (``utils/stats.LAUNCHES``) are set to 0 just
   before each path and read just after: each facade must launch K1 and K2
   once a step and ground segmentation, the node all three, the probe tool
   the probe kernel;
3. holds each kernel against its plain twin on the card: K1's bits and K2's
   labels, converged flag and rounds on the KITTI window, ground
   segmentation on a host-inserted KITTI step (every state field), the
   probe variants in step 2;
4. runs the card suite, ``python -m pytest --noconftest -m cuda tests/``,
   which holds every path against the oracle, the CPU or itself;
5. times each kernel (``scripts/kernel_times.py``).

The line before the last is a JSON object with one entry per kernel:
``launches`` summed over step 2's paths, ``max_abs_err`` of step 3, and of
step 5's first input of the kernel (the KITTI window, the probe's slowest
variant, the KITTI step) ``ms``, ``device_ms``, ``plain_ms`` and
``bound_ms``.  The last line is ``{"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}``.  Exits 2 without a CUDA device;
raises on any failed check.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROWS, COLS, BATCH = 64, 2200, 384     # the KITTI configuration's main path
KERNELS = ("edge_bits", "window_cc", "sweep_probe", "ground_segment")
# what each kernel replaces in the JAX package and its scripts
SOURCES = {"edge_bits": "continuous_clustering_tpu/ops/cc_pallas.py:444",
           "window_cc": "continuous_clustering_tpu/ops/cc_pallas.py:202",
           "sweep_probe": "scripts/pallas_bisect.py:26", "ground_segment": None}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_abs_diff(a, b) -> float:
    if a.dtype.is_floating_point:
        check(bool((a.isnan() == b.isnan()).all()), "NaN cells differ")
        a, b = a.nan_to_num(), b.nan_to_num()
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def drive_paths(dev) -> dict:
    """Step 2: the launches of each path, summed per kernel."""
    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.tools import cc_windows
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp
    from continuous_clustering_tpu_torch.tools.sweep_probe import run as probe_run
    from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

    total = dict.fromkeys(KERNELS, 0)

    def read(path, want):
        check(all(LAUNCHES[k] > 0 for k in want), f"{path}: a kernel was not launched: {LAUNCHES}")
        print(f"{path}: launches {LAUNCHES}", flush=True)
        for k in KERNELS:
            total[k] += LAUNCHES[k]

    firings = cc_windows.stream_firings(ROWS, COLS, 2)
    for insertion in ("host", "device"):
        pipe, clusters = cc_windows._facade(kitti_config(), ROWS, BATCH, dev, insertion), []
        pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(len(pts)))
        reset_launch_counts()
        for f in firings:
            pipe.add_firing(f, np.eye(4))
        pipe.flush()
        check(LAUNCHES["edge_bits"] == LAUNCHES["window_cc"] == pipe.n_steps and clusters,
              f"{insertion} insertion: {pipe.n_steps} steps, {len(clusters)} clusters")
        read(f"facade, {insertion} insertion", ("edge_bits", "window_cc", "ground_segment"))

    desc, clusters = launch.sensor_vls128_roof(), []
    frames = sp.scene_frames(128, desc.config.range_image.num_columns, 2,
                             sp.velodyne_inclinations(128), seed=7, num_boxes=16, spread=30.0)
    node = launch.make_node(desc, firing_batch_size=128, device=dev)
    node.publish_cluster = lambda pts, stamp: clusters.append(len(pts))
    reset_launch_counts()
    sp.feed(node, sp.velodyne_packets(frames))
    check(clusters, "the node published no cluster")
    read("node, VLS-128 from packets", ("edge_bits", "window_cc", "ground_segment"))

    reset_launch_counts()
    results = probe_run(str(dev))
    check(all(s == "OK" for _, s, _ in results), f"probe variants: {results}")
    read("probe tool", ("sweep_probe",))
    total["probe_err"] = max(err for _, _, err in results)
    return total


def kernels_against_twins(dev) -> dict:
    """Step 3: the largest difference of each kernel from its twin."""
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.ops import cc_cuda
    from continuous_clustering_tpu_torch.ops.ground_segmentation import (
        ground_segment_columns, ground_segment_columns_reference)
    from continuous_clustering_tpu_torch.ops.state import copy_state
    from continuous_clustering_tpu_torch.tools import cc_windows

    cfg = kitti_config()
    cl = cfg.clustering
    H, V, md = cl.max_steps_in_row, cl.max_steps_in_column, np.float32(cl.max_distance)
    win = cc_windows.stream_window(cfg, ROWS, BATCH, cc_windows.stream_firings(ROWS, COLS, 2),
                                   [3 * COLS // 2], dev)
    args = [getattr(win, f) for f in ("xw", "yw", "zw", "incw", "active_w", "mad", "wp")]
    kw = dict(H=H, V=V, max_d2=float(md * md))
    bits = cc_cuda.edge_bits(*args, **kw)
    err = {"edge_bits": max_abs_diff(bits, cc_cuda.edge_bits_reference(*args, **kw))}
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    got = cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V)
    want = cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V)
    check(all(bool((a == b).all()) for a, b in zip(got[1:], want[1:])),
          "K2: converged flag or rounds differ from the twin")
    err["window_cc"] = max_abs_diff(got[0], want[0])
    state, seg_in, B, _ = cc_windows.segment_step(cfg, ROWS, BATCH, dev)
    a = ground_segment_columns(cfg, copy_state(state), seg_in, B)
    b = ground_segment_columns_reference(cfg, copy_state(state), seg_in, B)
    err["ground_segment"] = max(max_abs_diff(getattr(a, f), getattr(b, f)) for f in vars(b))
    print(f"kernels against their twins: {err}", flush=True)
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import kernel_times
    from continuous_clustering_tpu_torch import native
    from continuous_clustering_tpu_torch.ops import cc_cuda

    t0 = time.perf_counter()
    card = kernel_times.card_name()
    print(f"{card['card']}, {card['power_limit']}", flush=True)
    native.load()
    cc_cuda.load_kernels()
    print(f"built the native library and the kernels in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    launches = drive_paths(dev)
    err = {"sweep_probe": launches.pop("probe_err"), **kernels_against_twins(dev)}
    suite = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
                            "no:cacheprovider", "-m", "cuda", "tests/"], cwd=ROOT)
    check(suite.returncode == 0, f"the card suite failed (exit code {suite.returncode})")
    first = {}
    for rec in kernel_times.measure(card):
        if rec["kernel"] not in first or (rec["kernel"] == "sweep_probe"
                                          and rec["device_ms"] > first["sweep_probe"]["device_ms"]):
            first[rec["kernel"]] = rec
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"continuous_clustering_tpu_torch/csrc/{k}.cu",
         "replaces": SOURCES[k], "launches": launches[k], "max_abs_err": err[k],
         **{m: first[k][m] for m in ("inputs", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by")}, "library_ms": None} for k in KERNELS]}))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, builds included")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
