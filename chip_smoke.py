#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the native host library and the two CUDA kernels from the sources in
this checkout (into ``continuous_clustering_tpu_torch/build/``), then:

1. prints the card's name and power limit and the build times;
2. holds each kernel against its plain PyTorch twin on the card, on a real
   association window of the KITTI-shaped synthetic stream (R = 64,
   B = 416), and times both with CUDA events;
3. checks the port facade on the card against the sequential oracle at
   32 x 220 (partition >= 0.995, ground labels exact) and on the serpentine
   stream (converges, stays one component);
4. streams the KITTI configuration (64 x 2200, firing batch 384) through
   ``ContinuousClustering.add_firing`` on the card, with launch counters
   reset just before, and holds the published partition against the same
   stream run on the CPU (the plain twins).

Every phase raises on failure.  The second-to-last line is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B_FIRINGS = 384            # firing batch of the streamed KITTI configuration
FULL_ROWS, SMALL_ROWS, SMALL_COLS = 64, 32, 220


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kitti_stream(num_rows, num_cols, n_rev, seed=5, num_boxes=14):
    """Firings of ``n_rev`` revolutions of one synthetic KITTI-like scene."""
    from continuous_clustering_tpu.evaluation.synthetic import (
        frame_to_firings, make_scene, raycast_frame)

    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=30.0)
    firings = []
    for f in range(n_rev):
        xyz, _ = raycast_frame(scene, num_rows=num_rows, num_columns=num_cols, seed=seed + f)
        firings += frame_to_firings(xyz, start_stamp=f * 100_000_000,
                                    end_stamp=(f + 1) * 100_000_000, frame_index=f)
    return firings


def small_config():
    from continuous_clustering_tpu.config import kitti_config

    cfg = kitti_config()
    return cfg.replace(
        range_image=dataclasses.replace(cfg.range_image, num_columns=SMALL_COLS,
                                        ring_buffer_revolutions=4),
        clustering=dataclasses.replace(cfg.clustering, stop_after_association_enabled=False))


def run_facade(cfg, num_rows, firings, device, batch, stop_after=None):
    """Stream ``firings`` through the port facade; returns (labels by point,
    ground labels by point, clusters, facade).  With ``stop_after``, only
    columns published before the firing of that index count."""
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

    pipe = ContinuousClustering(cfg, firing_batch_size=batch, device=device)
    pipe.reset(num_rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    labels, ground, clusters = {}, {}, []
    live = {"on": True}

    def on_col(a, b, ground_only):
        if ground_only or not live["on"]:
            return
        cloud = pipe.get_columns(a, b)
        valid = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        for u, i, g in zip(cloud["globally_unique_point_index"][valid],
                           cloud["id"][valid], cloud["ground_point_label"][valid]):
            labels[int(u)] = int(i)
            ground[int(u)] = int(g)

    pipe.set_finished_column_callback(on_col)
    pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append((pts, stamp)))
    eye = np.eye(4)
    for k, f in enumerate(firings):
        if stop_after is not None and k == stop_after:
            live["on"] = False
        pipe.add_firing(f, eye)
    pipe.flush()
    return labels, ground, clusters, pipe


def real_window(cfg, device, firings):
    """Kernel inputs of the last association step after 1.5 revolutions of
    the full-size stream: a real (R, H + B) window of the main path."""
    import torch

    from continuous_clustering_tpu_torch.ops.association import window_arrays

    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

    pipe = ContinuousClustering(cfg, firing_batch_size=B_FIRINGS, device=device)
    pipe.reset(FULL_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    for f in firings[: 3 * cfg.range_image.num_columns // 2]:
        pipe.add_firing(f, np.eye(4))
    B = B_FIRINGS + 32
    state = pipe.state
    gcol0 = state.first_unfinished - B
    return window_arrays(cfg, state, gcol0, torch.tensor(B, dtype=torch.int32, device=device), B)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "continuous_clustering_tpu_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from continuous_clustering_tpu.config import kitti_config
    from continuous_clustering_tpu.evaluation.partition import partition_agreement
    from continuous_clustering_tpu.ops.oracle import OracleContinuousClustering
    from continuous_clustering_tpu_torch import native
    from continuous_clustering_tpu_torch.ops import cc_cuda

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: card, builds ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    native.load()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc_cuda.load_kernels()
    t_kernels = time.perf_counter() - t0
    print(f"phase 1: {kind}; built native lib in {t_native:.2f} s, CUDA kernels in "
          f"{t_kernels:.2f} s")

    # ---- phase 2: kernels vs plain twins at the main path's shapes ----------
    cfg = kitti_config()
    cl = cfg.clustering
    H, V = cl.max_steps_in_row, cl.max_steps_in_column
    n_cols = cfg.range_image.num_columns
    firings = kitti_stream(FULL_ROWS, n_cols, n_rev=5)
    win = real_window(cfg, dev, firings)
    max_d2 = float(np.float32(cl.max_distance) * np.float32(cl.max_distance))
    k1_args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
    k1_kw = dict(H=H, V=V, max_d2=max_d2)
    bits = cc_cuda.edge_bits(*k1_args, **k1_kw)
    bits_ref = cc_cuda.edge_bits_reference(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    n_set = int(np.unpackbits(bits.cpu().numpy().view(np.uint8)).sum())
    k1_err = int((bits.long() - bits_ref.long()).abs().max())
    check(n_set > 0, "the real window has no edges")
    check(torch.equal(bits, bits_ref), f"K1 bits differ from the plain twin (max |diff| {k1_err})")
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    lab, ok, rounds = cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V)
    lab_ref, ok_ref, rounds_ref = cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V)
    torch.cuda.synchronize()
    k2_err = int((lab.long() - lab_ref.long()).abs().max())
    check(torch.equal(lab, lab_ref), f"K2 labels differ from the plain twin (max |diff| {k2_err})")
    check(bool(ok) == bool(ok_ref) and bool(ok), "K2 converged flag differs or is false")
    k1_ms = median_ms(lambda: cc_cuda.edge_bits(*k1_args, **k1_kw))
    k1_plain_ms = median_ms(lambda: cc_cuda.edge_bits_reference(*k1_args, **k1_kw), n=5)
    k2_ms = median_ms(lambda: cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V))
    k2_plain_ms = median_ms(lambda: cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V), n=5)
    print(f"phase 2: window R={win.active_w.shape[0]} WCOL={win.active_w.shape[1]}, "
          f"{int(win.active_w.sum())} active cells, {n_set} edge bits set; K1 bits equal; "
          f"K2 labels equal (rounds kernel {int(rounds)}, plain {int(rounds_ref)}); "
          f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms; "
          f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms")

    # ---- phase 3: oracle and serpentine at 32 x 220 -------------------------
    from continuous_clustering_tpu.evaluation.synthetic import (
        frame_to_firings, make_scene, raycast_frame)

    scfg = small_config()
    scene = make_scene(num_boxes=8, seed=1, spread=20.0)
    sfirings = []
    for f in range(2):
        xyz, _ = raycast_frame(scene, num_rows=SMALL_ROWS, num_columns=SMALL_COLS, seed=1 + f)
        sfirings += frame_to_firings(xyz, frame_index=f)
    oracle = OracleContinuousClustering(scfg, SMALL_ROWS)
    oracle.set_transform_robot_from_sensor(np.eye(4))
    o_labels, o_ground = {}, {}

    def on_oracle_col(a, b, ground_only):
        if ground_only:
            return
        for g in range(a, b + 1):
            for r in range(SMALL_ROWS):
                c = oracle.cells[g % scfg.ring_buffer_max_columns][r]
                if c.globally_unique_point_index != -1:
                    o_labels[c.globally_unique_point_index] = c.id
                    o_ground[c.globally_unique_point_index] = c.ground_point_label

    oracle.finished_column_callback = on_oracle_col
    for f in sfirings:
        oracle.add_firing(f, np.eye(4))
    p_labels, p_ground, p_clusters, _ = run_facade(scfg, SMALL_ROWS, sfirings, dev, 64)
    common = set(o_labels) & set(p_labels)
    check(len(common) > 0.9 * len(o_labels), "too few points in common with the oracle")
    g_match = float(np.mean([o_ground[k] == p_ground[k] for k in common]))
    agree = partition_agreement(o_labels, p_labels)
    check(g_match == 1.0, f"ground labels agree on {g_match}")
    check(agree >= 0.995, f"oracle partition agreement {agree}")
    check(p_clusters and all(len(p) > 20 for p, _ in p_clusters), "no valid clusters")
    snake_labels, _, _, _ = run_facade(scfg, SMALL_ROWS, serpentine_firings(), dev, 48)
    snake_ids = set(snake_labels.values()) - {0}
    check(len(snake_labels) > 300 and len(snake_ids) <= 2,
          f"serpentine: {len(snake_labels)} points in {len(snake_ids)} clusters")
    print(f"phase 3: oracle agreement {agree:.6f} on {len(common)} points, ground exact; "
          f"serpentine converged, {len(snake_labels)} points in {len(snake_ids)} cluster(s)")

    # ---- phase 4: the main path at full size ---------------------------------
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

    pipe = ContinuousClustering(cfg, firing_batch_size=B_FIRINGS, device=dev)
    pipe.reset(FULL_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    published, clusters = [], []

    def on_col(a, b, ground_only):
        if ground_only:
            return
        cloud = pipe.get_columns(a, b)
        valid = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        published.append((cloud["globally_unique_point_index"][valid], cloud["id"][valid]))

    pipe.set_finished_column_callback(on_col)
    pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(len(pts)))
    eye = np.eye(4)
    revs = [firings[r * n_cols:(r + 1) * n_cols] for r in range(5)]
    for f in revs[0]:                      # warm-up revolution
        pipe.add_firing(f, eye)
    torch.cuda.synchronize()
    cc_cuda.reset_launch_counts()
    steps0 = pipe.n_steps
    t0 = time.perf_counter()
    for rev in revs[1:4]:                  # three timed revolutions
        for f in rev:
            pipe.add_firing(f, eye)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cc_cuda.LAUNCHES)
    steps = pipe.n_steps - steps0
    points = sum(int(np.isfinite(f["xyz"][:, 0]).sum()) for rev in revs[1:4] for f in rev)
    # host <-> device synchronisations per step, over one more revolution
    torch.cuda.set_sync_debug_mode("warn")
    steps1 = pipe.n_steps
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for f in revs[4]:
            pipe.add_firing(f, eye)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    sync_steps = pipe.n_steps - steps1
    pipe.flush()
    torch.cuda.synchronize()
    check(steps > 0 and launches["edge_bits"] == steps and launches["window_cc"] == steps,
          f"launches {launches} != association steps {steps}")
    check(len(clusters) > 0, "no clusters were published")
    print(f"phase 4: {kind}, power limit {smi.split(',')[-1].strip()}: 3 revolutions of "
          f"{FULL_ROWS} x {n_cols} at firing batch {B_FIRINGS}: {points} points in "
          f"{dt:.3f} s = {points / dt:.0f} points/s; {steps} steps, {dt / steps * 1e3:.2f} ms/step; "
          f"launches {launches}; {len(clusters)} clusters published; "
          f"{syncs / max(sync_steps, 1):.2f} host-device syncs per step over {sync_steps} steps")

    gpu_labels = {int(u): int(i) for us, ids in published for u, i in zip(us, ids)}
    # the CPU leg: the first two revolutions through the plain twins; only
    # columns published before the last revolution's end count
    cpu_n = 2 * n_cols
    t0 = time.perf_counter()
    cpu_labels, _, _, _ = run_facade(cfg, FULL_ROWS, firings[:cpu_n], "cpu", B_FIRINGS,
                                     stop_after=cpu_n - B_FIRINGS)
    t_cpu = time.perf_counter() - t0
    common = set(cpu_labels) & set(gpu_labels)
    agree = partition_agreement(
        {k: cpu_labels[k] for k in common}, {k: gpu_labels[k] for k in common})
    check(len(common) == len(cpu_labels) > 10000,
          f"{len(common)} of the CPU leg's {len(cpu_labels)} points published on the card")
    check(agree == 1.0, f"card vs CPU partition agreement {agree}")
    print(f"phase 4: CPU leg ({cpu_n // n_cols} revolutions, plain twins, {t_cpu:.1f} s): "
          f"partition agreement {agree} on {len(common)} points")

    print(json.dumps({"kernels": [
        {"name": "edge_bits", "route": "cuda",
         "source": "continuous_clustering_tpu_torch/csrc/edge_bits.cu",
         "replaces": "continuous_clustering_tpu/ops/cc_pallas.py:444",
         "launches": launches["edge_bits"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "window_cc", "route": "cuda",
         "source": "continuous_clustering_tpu_torch/csrc/window_cc.cu",
         "replaces": "continuous_clustering_tpu/ops/cc_pallas.py:202",
         "launches": launches["window_cc"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def serpentine_firings():
    """Two revolutions of one two-cell-thick zigzag ribbon at 6 m spanning
    the whole rotation (the adversarial CC input of tests/test_cc_pallas.py)."""
    from continuous_clustering_tpu.evaluation.synthetic import frame_to_firings

    R, C = SMALL_ROWS, SMALL_COLS
    inc = np.deg2rad(np.linspace(2.0, -24.8, R))
    az = np.pi - np.arange(C) * (2.0 * np.pi / C)
    xyz = np.full((R, C, 3), np.nan, np.float32)
    period = 24
    for c in range(C):
        ph = c % period
        r = 2 + (ph if ph < 12 else period - ph)
        for dr in (0, 1):
            row = min(R - 1, r + dr)
            xyz[row, c] = 6.0 * np.array([np.cos(inc[row]) * np.cos(az[c]),
                                          np.cos(inc[row]) * np.sin(az[c]),
                                          np.sin(inc[row])])
    cols = xyz.transpose(1, 0, 2)
    return frame_to_firings(cols, frame_index=0) + frame_to_firings(cols, frame_index=1)


if __name__ == "__main__":
    sys.exit(main())
