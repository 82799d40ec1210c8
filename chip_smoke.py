#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from the sources in
this checkout (into ``continuous_clustering_tpu_torch/build/``, the builds
side by side), then:

1. prints the card's name and power limit and the build times;
2. holds K1 and K2 against their plain PyTorch twins on the card (bits;
   labels, converged flag and round count) on two real association windows
   at R = 64, B = 416 (the KITTI-shaped stream, and the densest of a few
   windows of the ``near_field`` throughput scene), on a snake window that
   runs into the 64-round cap, and on a random window at R = 128, B = 512,
   and times both kernels on both real windows with CUDA events; then one
   K1 launch over the two real windows stacked and one K2 launch over
   them and the snake, each stream against its own window's twin (3, 4
   and 64 unconverged rounds in one launch);
3. checks the port facade on the card against the sequential oracle at
   32 x 220 (partition >= 0.995, ground labels exact), on the serpentine
   stream (converges, stays one component), and at 8 x 220 on host
   insertion (the two-buffer staging below 15 rows) against the same stream
   on the CPU (partition, ground labels and cluster sizes equal);
4. streams the KITTI configuration (64 x 2200, firing batch 384) through
   ``ContinuousClustering.add_firing`` (host insertion) on the card and
   holds the published partition against the same stream run on the CPU
   (the plain twins);
5. streams 3 revolutions of the same configuration through device insertion
   (``insertion="device"``, ``pipeline_step``), times it, breaks one step
   down, and holds the partition against the CPU;
6. checkpoints half of the phase-3 stream on the card, resumes it in a fresh
   facade and holds the partition against the uninterrupted run (>= 0.99);
7. runs the periodic block runner (``tools/bench_setup.py``) on the three
   throughput scenes and reports the steady rate of each; the ``standard``
   scene runs twice and must give the same checksum;
8. runs the CC sweep's probe variants through their tool
   (``tools/sweep_probe.py``) at upper = 1, 7 and 21, each against its
   twin, and times each kernel at upper = 21 (device time, with the host's
   enqueue, the plain twin) beside its bound;
9. streams three sensors of the KITTI configuration, each its own scene
   for 2 revolutions, through the multi-sensor step
   (``parallel/multi_sensor.py``, K1 and K2 launched once per step for all
   streams), times it, counts one step's device kernels under the
   profiler, and holds every stream's published partition, meta and state
   against the same stream run alone through ``pipeline_step`` on the card;
10. drives the sensor entry point (``launch.py`` -> ``ClusteringNode``) on
    the card from raw packets encoded here from a ray-cast scene
    (``tools/sensor_packets.py``): the VLS-128 roof preset at its full
    width (128 x 1700, decode thread, asynchronous, ring of 10 revolutions)
    and both OS-32 presets (32 x 1024, fog filtering on; their sensor_info
    written to a temporary directory), 2 revolutions each, the reference's
    three-node ``demo_touareg``; each holds its published partition and
    clusters against the same packets through the same preset on the CPU;
    then runs ``tools/latency_bench.py`` on the card (64 x 2200, batch 128,
    600 rpm pacing, 2 revolutions) and prints its percentiles;
11. runs the KITTI evaluation on the card: writes a synthetic KITTI-shaped
    sequence of 3 frames at 64 x 2200 (HDL-64 inclinations, ego speed 5 m/s)
    to a temporary folder, generates its euclidean ground truth
    (``tools/gt_label_generator.py``), runs ``tools/kitti_demo.KittiDemo``
    on the card (host insertion, firing batch 256) and holds each frame's
    ``FrameResult`` and the published partition against the same demo on
    the CPU, exactly; then ``tools/html_viewer.main`` once on the card at
    32 x 220 (its payload must hold points and clusters);
12. runs the column-sharded halo step (``parallel/halo.py``) with every
    shard on the card: the phase-4 scene at 64 x 2200 (3 revolutions,
    captured once with the host insertion) through the unsharded
    ``pipeline_step_block`` and the halo step with nsp 4, both with the
    publish slab; nsp 8 over the first revolution; two streams over
    dp 2 x sp 4 in one stacked step.  Every ring field, the slot table, the
    scalars and every step's meta, slab and tail must equal the unsharded
    run's; prints ms per step of each beside the unsharded step's;
13. runs device insertion into column-sharded rings: phase 12's two scenes
    as firing batches (384) over the first revolution through the
    multi-sensor step on a dp 2 x sp 4 mesh, every shard on the card
    (``make_sharded_step(mesh=...)``, the firing loop on each stream's
    gathered ``distance`` plane, each winner written to the shard that owns
    its column), slab 128 / 64, against the unsharded
    ``make_sharded_step(device=...)`` on the same batches; then dp 1 x sp 8
    over the first 3 steps.  Every step's meta, slab and tail and every
    state field must be equal; prints ms per step of both and the device
    kernels of one step of each under the profiler;
14. holds the ground segmentation kernel (``csrc/ground_segment.cu``)
    against its twin on the card, every state field bit for bit, on a
    host-inserted step of the KITTI configuration (64 x 416) and of the
    VLS-128 roof preset (128 x 288), after the steps before it ran through
    ``pipeline_step_block`` (one launch a step), and times the kernel beside
    its byte bound and the twin.

Phases 3 to 14 drive the port's paths; the kernels' launch counters are set
to 0 just before each and read just after, and each of phases 3-7 and 9-13
must have launched K1, K2 and the ground segmentation kernel (phases 9, 12
and 13 K1 and K2 once per step), phase 8 the probe kernel.  Every phase
raises on failure.  The line before the last is a JSON
object with one entry per kernel (launches summed over phases 3-14;
``max_abs_err`` over every
comparison with the twin; ``ms`` with the host's enqueue, ``device_ms``
without; K1 and K2 on the KITTI window, the probe's slowest variant at
upper = 21, ground segmentation on the KITTI step; ``bound_ms`` for the
same inputs); the last line is ``{"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}``.  Exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B_FIRINGS = 384            # firing batch of the streamed KITTI configuration
FULL_ROWS, SMALL_ROWS, SMALL_COLS = 64, 32, 220
FEW_ROWS = 8               # below the 15 rows the merged staging buffer needs
# one NVIDIA H100 SXM (data sheet): HBM rate and the f32 rate outside the
# tensor cores, the roofline of both kernels (neither uses the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per candidate pair of K1's wedge walk: the inclination
# test (sub, abs, compare), the squared distance (3 sub, 3 mul, 2 add) and
# the radius compare
K1_OPS_PER_PAIR = 12
# integer operations per cell and step of a probe variant (lane index,
# mask, select, min)
PROBE_OPS_PER_CELL_STEP = 4
# device cycles the card sleeps before a timed launch, so that the launch
# is enqueued before the start event runs and the time is the device's
# (about 1 ms at the H100's clock)
SLEEP_CYCLES = 2_000_000


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, n: int = 20, warmup: int = 3, device_only: bool = False) -> float:
    """Median of ``n`` CUDA-event times of ``fn``.  By default the time runs
    from the start event to the end event as the host issues them, so it
    includes the host's time to enqueue ``fn``; with ``device_only`` the
    card first sleeps ``SLEEP_CYCLES`` so ``fn`` is enqueued before the
    start event runs, and the time is the device's alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Launches:
    """Kernel launches of the driven phases: the counters are set to 0 just
    before a phase and added up just after it."""

    def __init__(self):
        from continuous_clustering_tpu_torch.ops import cc_cuda, sweep_probe

        self.modules = (cc_cuda, sweep_probe)
        self.total = {k: 0 for m in self.modules for k in m.LAUNCHES}

    def start(self):
        for m in self.modules:
            m.reset_launch_counts()

    def stop(self, phase: str, kernels=("edge_bits", "window_cc", "ground_segment")):
        got = {k: v for m in self.modules for k, v in m.LAUNCHES.items()}
        check(all(got[k] > 0 for k in kernels), f"{phase}: a kernel was not launched: {got}")
        for k, v in got.items():
            self.total[k] += v
        return {k: got[k] for k in kernels}


def kitti_stream(num_rows, num_cols, n_rev, seed=5, num_boxes=14):
    """Firings of ``n_rev`` revolutions of one synthetic KITTI-like scene."""
    from continuous_clustering_tpu_torch.evaluation.synthetic import (
        frame_to_firings, make_scene, raycast_frame)

    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=30.0)
    firings = []
    for f in range(n_rev):
        xyz, _ = raycast_frame(scene, num_rows=num_rows, num_columns=num_cols, seed=seed + f)
        firings += frame_to_firings(xyz, start_stamp=f * 100_000_000,
                                    end_stamp=(f + 1) * 100_000_000, frame_index=f)
    return firings


def small_config():
    from continuous_clustering_tpu_torch.config import kitti_config

    cfg = kitti_config()
    return cfg.replace(
        range_image=dataclasses.replace(cfg.range_image, num_columns=SMALL_COLS,
                                        ring_buffer_revolutions=4),
        clustering=dataclasses.replace(cfg.clustering, stop_after_association_enabled=False))


def make_facade(cfg, num_rows, device, batch, insertion="host"):
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

    pipe = ContinuousClustering(cfg, firing_batch_size=batch, device=device,
                                insertion=insertion)
    pipe.reset(num_rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    return pipe


def collect(pipe, labels, ground=None, clusters=None, live=None):
    """Register callbacks that record each published point's cluster id (and
    ground label) and each published cluster's size."""

    def on_col(a, b, ground_only):
        if ground_only or (live is not None and not live["on"]):
            return
        cloud = pipe.get_columns(a, b)
        valid = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        for u, i, g in zip(cloud["globally_unique_point_index"][valid],
                           cloud["id"][valid], cloud["ground_point_label"][valid]):
            labels[int(u)] = int(i)
            if ground is not None:
                ground[int(u)] = int(g)

    pipe.set_finished_column_callback(on_col)
    if clusters is not None:
        pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(len(pts)))


def run_facade(cfg, num_rows, firings, device, batch, stop_after=None, insertion="host"):
    """Stream ``firings`` through the port facade; returns (labels by point,
    ground labels by point, cluster sizes, facade).  With ``stop_after``,
    only columns published before the firing of that index count."""
    pipe = make_facade(cfg, num_rows, device, batch, insertion)
    labels, ground, clusters = {}, {}, []
    live = {"on": True}
    collect(pipe, labels, ground, clusters, live)
    eye = np.eye(4)
    for k, f in enumerate(firings):
        if stop_after is not None and k == stop_after:
            live["on"] = False
        pipe.add_firing(f, eye)
    pipe.flush()
    return labels, ground, clusters, pipe


def real_window(cfg, device, firings, stops):
    """Kernel inputs of the association step after each of ``stops``
    firings of the full-size stream, real (R, H + B) windows of the main
    path: the one with the most active cells."""
    import torch

    from continuous_clustering_tpu_torch.ops.association import window_arrays

    pipe = make_facade(cfg, FULL_ROWS, device, B_FIRINGS)
    B = B_FIRINGS + 32
    best, fed = None, 0
    for stop in stops:
        for f in firings[fed:stop]:
            pipe.add_firing(f, np.eye(4))
        fed = stop
        state = pipe.state
        win = window_arrays(cfg, state, state.first_unfinished - B,
                            torch.tensor(B, dtype=torch.int32, device=device), B)
        if best is None or int(win.active_w.sum()) > int(best.active_w.sum()):
            best = win
    return best


def agreement_with_cpu(gpu_labels, cpu_labels, what):
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement

    common = set(cpu_labels) & set(gpu_labels)
    agree = partition_agreement(
        {k: cpu_labels[k] for k in common}, {k: gpu_labels[k] for k in common})
    check(len(common) == len(cpu_labels) > 10000,
          f"{what}: {len(common)} of the CPU leg's {len(cpu_labels)} points published on the card")
    check(agree == 1.0, f"{what}: card vs CPU partition agreement {agree}")
    return agree, len(common)


def build_all():
    """Build the native library and the kernels side by side; returns the
    seconds each took."""
    from continuous_clustering_tpu_torch import native
    from continuous_clustering_tpu_torch.ops import cc_cuda

    times, errors = {}, []

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=timed, args=("native", native.load)),
               threading.Thread(target=timed, args=("kernels", cc_cuda.load_kernels))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return times


def max_abs_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def check_window_cc(what, bits, L0, max_wp, H, V, converged):
    """K2 on the card against its twin: labels, converged flag and round
    count exactly; returns (the round count, max |label - twin's label|)."""
    import torch

    from continuous_clustering_tpu_torch.ops import cc_cuda

    lab, ok, rounds = cc_cuda.window_cc(bits, L0, max_wp, H=H, V=V)
    lab_ref, ok_ref, rounds_ref = cc_cuda.window_cc_reference(bits, L0, max_wp, H=H, V=V)
    torch.cuda.synchronize()
    err = max_abs_diff(lab, lab_ref)
    check(torch.equal(lab, lab_ref), f"{what}: K2 labels differ from the plain twin "
          f"(max |diff| {err})")
    check(bool(ok) == bool(ok_ref) == converged,
          f"{what}: converged kernel {bool(ok)}, plain {bool(ok_ref)}, expected {converged}")
    check(int(rounds) == int(rounds_ref),
          f"{what}: rounds kernel {int(rounds)}, plain {int(rounds_ref)}")
    return int(rounds), err


def bound(nbytes: int, ops: int) -> dict:
    """The larger of ``nbytes`` over the HBM rate and ``ops`` over the f32
    rate, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, ops=ops)


def kernel_bounds(win, bits, max_wp, rounds, H, V):
    """Least time the card could take for each kernel's work on this
    window.  Bytes: each input the kernel reads once, each output written
    once.  K1 reads the window and writes every plane of bits; K2 reads the
    two words of bits for the column offsets it uses, dc < min(max_wp, H) +
    1 (the scans' links, bits[1] and bits[0], among them), and the labels.
    Operations: K1's candidate pairs of this window (active batch points x
    column offsets up to their wedge x 2V + 1 row offsets); K2's per-round
    edge relaxations and scans of this run's rounds (integer min, counted at
    the f32 rate)."""
    R, WCOL = win.active_w.shape
    B = WCOL - H
    f32 = 4
    k1_bytes = (4 * R * WCOL * f32 + R * WCOL * 1 + 2 * R * B * f32
                + bits.numel() * f32)
    active_b = win.active_w[:, H:]
    pairs = int(((win.wp.clamp(max=H) + 1) * active_b).sum()) * (2 * V + 1)
    k1_ops = pairs * K1_OPS_PER_PAIR
    n_edges = int(np.unpackbits(bits.cpu().numpy().view(np.uint8)).sum())
    planes = set(range(2 * (min(int(max_wp), H) + 1)))   # (dc, word) planes
    if H >= 1:
        planes.add(2 + V // 32)
    if V >= 1:
        planes.add((V - 1) // 32)
    k2_bytes = len(planes) * R * B * f32 + 2 * R * WCOL * f32 + 4 + 8
    k2_ops = int(rounds) * (n_edges + 4 * R * WCOL)
    return {"edge_bits": bound(k1_bytes, k1_ops), "window_cc": bound(k2_bytes, k2_ops)}


def probe_bounds(name, L, upper):
    """Least time for one launch of probe variant ``name`` at ``upper``.
    Bytes: the labels in and out, and for V3, V3i and V4 word 0 of bits[dc]
    for dc < upper (no variant reads word 1, the others no bits).
    Operations: one step per cell for V0 and V1, ``upper`` for V2 and V5
    (three bands each for V5), 3 x ``upper`` for V3, V3i and V4, three
    compares for V6."""
    from continuous_clustering_tpu_torch.ops.sweep_probe import B, R

    reads_bits = name in ("V3_bool_mask", "V3i_i32_mask", "V4_mask_scratch")
    steps = {"V0_init_copy": 1, "V1_static_slice_roll": 1, "V2_dynamic_roll": upper,
             "V5_cmp_astype_prefix": 3 * upper, "V6_bitpack": 3}.get(name, 3 * upper)
    nbytes = (upper * R * B * 4 if reads_bits else 0) + 2 * L.numel() * 4
    return bound(nbytes, steps * L.numel() * PROBE_OPS_PER_CELL_STEP)


def device_profile(fn):
    """(device kernels launched, device busy ms, wall ms) of ``fn`` under
    ``torch.profiler``; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device-side copies of the program's spans are no device work
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels or busy <= 0:
        return None
    return len(kernels), busy, wall


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

    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.evaluation.synthetic import (
        frame_to_firings, make_scene, raycast_frame)
    from continuous_clustering_tpu_torch.models.checkpoint import load_state, save_state
    from continuous_clustering_tpu_torch.ops import cc_cuda, sweep_probe
    from continuous_clustering_tpu_torch.ops.oracle import OracleContinuousClustering
    from continuous_clustering_tpu_torch.tools import bench_setup, cc_windows
    from continuous_clustering_tpu_torch.tools import sweep_probe as probe_tool

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- phase 1: card, builds ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{kind}, power limit {smi.split(',')[-1].strip()}"
    t_build = build_all()
    print(f"phase 1: {kind}; built native lib in {t_build['native']:.2f} s and CUDA kernels "
          f"in {t_build['kernels']:.2f} s, side by side")

    # ---- phase 2: kernels vs plain twins at the main path's shapes ----------
    cfg = kitti_config()
    cl = cfg.clustering
    H, V = cl.max_steps_in_row, cl.max_steps_in_column
    n_cols = cfg.range_image.num_columns
    firings = kitti_stream(FULL_ROWS, n_cols, n_rev=5)
    near_firings, _ = bench_setup.make_bench_scene(FULL_ROWS, n_cols, "near_field")
    windows = {
        "kitti": real_window(cfg, dev, firings, [3 * n_cols // 2]),
        "near_field": real_window(cfg, dev, near_firings, range(n_cols // 4, n_cols, n_cols // 8)),
    }
    max_d2 = float(np.float32(cl.max_distance) * np.float32(cl.max_distance))
    k1_kw = dict(H=H, V=V, max_d2=max_d2)
    k2 = {}
    k2_inputs = {}   # (bits, L0, max_wp) of each window, the stacked launches' inputs
    # max |kernel - twin| over every comparison of each kernel in this run
    max_err = {"edge_bits": 0, "window_cc": 0}
    for wname, win in windows.items():
        k1_args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
        bits = cc_cuda.edge_bits(*k1_args, **k1_kw)
        bits_ref = cc_cuda.edge_bits_reference(*k1_args, **k1_kw)
        torch.cuda.synchronize()
        n_set = int(np.unpackbits(bits.cpu().numpy().view(np.uint8)).sum())
        check(n_set > 0, f"{wname}: the real window has no edges")
        err = max_abs_diff(bits, bits_ref)
        max_err["edge_bits"] = max(max_err["edge_bits"], err)
        check(torch.equal(bits, bits_ref), f"{wname}: K1 bits differ from the plain twin "
              f"(max |diff| {err})")
        max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
        k2_inputs[wname] = (bits_ref, win.L0, max_wp)
        rounds, err = check_window_cc(f"{wname} window", bits, win.L0, max_wp, H, V,
                                      converged=True)
        max_err["window_cc"] = max(max_err["window_cc"], err)
        t = dict(
            k1_ms=median_ms(lambda: cc_cuda.edge_bits(*k1_args, **k1_kw), device_only=True),
            k1_host_ms=median_ms(lambda: cc_cuda.edge_bits(*k1_args, **k1_kw)),
            k1_plain_ms=median_ms(lambda: cc_cuda.edge_bits_reference(*k1_args, **k1_kw), n=5),
            k2_ms=median_ms(lambda: cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V),
                            device_only=True),
            k2_host_ms=median_ms(lambda: cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V)),
            k2_plain_ms=median_ms(
                lambda: cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V), n=5),
            bounds=kernel_bounds(win, bits, max_wp, rounds, H, V))
        k2[wname] = t
        print(f"phase 2: {card}: {wname} window R={win.active_w.shape[0]} "
              f"WCOL={win.active_w.shape[1]}, {int(win.active_w.sum())} active cells, "
              f"{n_set} edge bits set, max_wp {int(max_wp)}; K1 bits equal; K2 labels, "
              f"converged and rounds ({rounds}) equal; K1 {t['k1_ms']:.4f} ms device "
              f"({t['k1_host_ms']:.4f} ms with the host's enqueue) vs plain "
              f"{t['k1_plain_ms']:.4f} ms, bound {t['bounds']['edge_bits']}; K2 "
              f"{t['k2_ms']:.4f} ms device ({t['k2_host_ms']:.4f} ms with the host's enqueue) "
              f"vs plain {t['k2_plain_ms']:.4f} ms, bound {t['bounds']['window_cc']}")
    # K2 beyond the streamed windows: the round cap, and a window larger than
    # one block's shared memory
    synthetic = {"snake": (cc_windows.snake_window(FULL_ROWS, B_FIRINGS + 32, H, V), False),
                 "R=128 B=512": (cc_windows.random_window(128, 512, H, V, seed=3), True)}
    for sname, (sw, converged) in synthetic.items():
        sbits, sL0, swp = (a.to(dev) for a in sw)
        rounds, err = check_window_cc(f"{sname} window", sbits, sL0, swp, H, V, converged)
        max_err["window_cc"] = max(max_err["window_cc"], err)
        print(f"phase 2: {sname} window {tuple(sL0.shape)}: K2 labels, converged "
              f"({converged}) and rounds ({rounds}) equal the plain twin's")
        if sname == "snake":
            k2_inputs[sname] = (sbits, sL0, swp)
    for name, err in check_stacked_kernels(windows, k2_inputs, k1_kw, H, V).items():
        max_err[name] = max(max_err[name], err)

    launches = Launches()

    # ---- phase 3: oracle and serpentine at 32 x 220 -------------------------
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
    launches.start()
    p_labels, p_ground, p_clusters, _ = run_facade(scfg, SMALL_ROWS, sfirings, dev, 64)
    common = set(o_labels) & set(p_labels)
    check(len(common) > 0.9 * len(o_labels), "too few points in common with the oracle")
    g_match = float(np.mean([o_ground[k] == p_ground[k] for k in common]))
    agree = partition_agreement(o_labels, p_labels)
    check(g_match == 1.0, f"ground labels agree on {g_match}")
    check(agree >= 0.995, f"oracle partition agreement {agree}")
    check(p_clusters and all(n > 20 for n in p_clusters), "no valid clusters")
    snake_labels, _, _, _ = run_facade(scfg, SMALL_ROWS, serpentine_firings(), dev, 48)
    snake_ids = set(snake_labels.values()) - {0}
    check(len(snake_labels) > 300 and len(snake_ids) <= 2,
          f"serpentine: {len(snake_labels)} points in {len(snake_ids)} clusters")
    few = few_rows_phase(scfg, dev)
    got = launches.stop("phase 3")
    print(f"phase 3: oracle agreement {agree:.6f} on {len(common)} points, ground exact; "
          f"serpentine converged, {len(snake_labels)} points in {len(snake_ids)} cluster(s); "
          f"{few}; launches {got}")

    # ---- phase 4: the host-insertion main path at full size ------------------
    pipe = make_facade(cfg, FULL_ROWS, dev, B_FIRINGS)
    published, clusters = {}, []
    collect(pipe, published, clusters=clusters)
    eye = np.eye(4)
    revs = [firings[r * n_cols:(r + 1) * n_cols] for r in range(5)]
    launches.start()
    for f in revs[0]:                      # warm-up revolution
        pipe.add_firing(f, eye)
    torch.cuda.synchronize()
    steps0 = pipe.n_steps
    t0 = time.perf_counter()
    for rev in revs[1:4]:                  # three timed revolutions
        for f in rev:
            pipe.add_firing(f, eye)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
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
    got = launches.stop("phase 4")
    check(got["edge_bits"] == got["window_cc"] == pipe.n_steps,
          f"launches {got} != association steps {pipe.n_steps}")
    check(len(clusters) > 0, "no clusters were published")
    print(f"phase 4: {card}: host insertion, 3 revolutions of {FULL_ROWS} x {n_cols} at "
          f"firing batch {B_FIRINGS}: {points} points in {dt:.3f} s = {points / dt:.0f} "
          f"points/s; {steps} steps, {dt / steps * 1e3:.2f} ms/step; launches {got}; "
          f"{len(clusters)} clusters published; {syncs / max(sync_steps, 1):.2f} host-device "
          f"syncs per step over {sync_steps} steps")
    # the CPU leg: the first two revolutions through the plain twins; only
    # columns published before the last firing batch count
    cpu_n = 2 * n_cols
    t0 = time.perf_counter()
    cpu_labels, _, _, _ = run_facade(cfg, FULL_ROWS, firings[:cpu_n], "cpu", B_FIRINGS,
                                     stop_after=cpu_n - B_FIRINGS)
    agree, n_common = agreement_with_cpu(published, cpu_labels, "phase 4")
    print(f"phase 4: CPU leg ({cpu_n // n_cols} revolutions, plain twins, "
          f"{time.perf_counter() - t0:.1f} s): partition agreement {agree} on {n_common} points")

    # ---- phase 5: device insertion at full size -----------------------------
    pipe = make_facade(cfg, FULL_ROWS, dev, B_FIRINGS, insertion="device")
    published, clusters = {}, []
    collect(pipe, published, clusters=clusters)
    dev_firings = firings[:3 * n_cols]
    launches.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in dev_firings:
        pipe.add_firing(f, eye)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = pipe.n_steps
    pipe.flush()
    torch.cuda.synchronize()
    got = launches.stop("phase 5")
    check(got["edge_bits"] == got["window_cc"] == pipe.n_steps,
          f"launches {got} != association steps {pipe.n_steps}")
    check(len(clusters) > 0, "no clusters were published")
    points = sum(int(np.isfinite(f["xyz"][:, 0]).sum()) for f in dev_firings)
    phase5 = dict(pts_s=points / dt, ms_step=dt / steps * 1e3)
    print(f"phase 5: {card}: device insertion, 3 revolutions of {FULL_ROWS} x {n_cols} at "
          f"firing batch {B_FIRINGS}: {points} points in {dt:.3f} s = {points / dt:.0f} "
          f"points/s; {steps} steps, {dt / steps * 1e3:.2f} ms/step; launches {got}; "
          f"{len(clusters)} clusters published")
    # one step broken down: insertion alone, and the whole step under the
    # profiler (device kernels launched, device busy time)
    from continuous_clustering_tpu_torch.models.step import pipeline_step
    from continuous_clustering_tpu_torch.ops.insertion import insert_firings
    from continuous_clustering_tpu_torch.ops.state import copy_state

    nxt = firings[3 * n_cols:3 * n_cols + B_FIRINGS]
    batch = pipe._make_batch(nxt, [eye] * len(nxt))
    ins_ms = []
    for _ in range(3):
        st = copy_state(pipe.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert_firings(cfg, st, batch)
        torch.cuda.synchronize()
        ins_ms.append((time.perf_counter() - t0) * 1e3)
    st = copy_state(pipe.state)
    launches.start()
    try:
        prof = device_profile(lambda: pipeline_step(cfg, st, batch, pipe._make_calib(),
                                                    pipe._batch_B, pipe._slab_W,
                                                    pipe._slab_W1))
    except RuntimeError as e:  # the profiler is an observer: its failure fails no check
        print(f"phase 5: torch.profiler failed: {e}")
        prof = None
    launches.stop("phase 5 profile")
    prof_txt = ("profiler saw no device time" if prof is None else
                f"one step under the profiler: {prof[0]} device kernels, device busy "
                f"{prof[1]:.2f} of {prof[2]:.2f} ms ({100 * prof[1] / prof[2]:.2f} %)")
    print(f"phase 5: insertion of {B_FIRINGS} firings alone {statistics.median(ins_ms):.2f} ms "
          f"(median of 3: {[round(t, 2) for t in ins_ms]}); {prof_txt}")
    cpu_n = 2 * n_cols
    t0 = time.perf_counter()
    cpu_labels, _, _, _ = run_facade(cfg, FULL_ROWS, firings[:cpu_n], "cpu", B_FIRINGS,
                                     stop_after=cpu_n - B_FIRINGS, insertion="device")
    agree, n_common = agreement_with_cpu(published, cpu_labels, "phase 5")
    print(f"phase 5: CPU leg ({cpu_n // n_cols} revolutions, device insertion on the CPU, "
          f"{time.perf_counter() - t0:.1f} s): partition agreement {agree} on {n_common} points")

    # ---- phase 6: checkpoint and resume on the card -------------------------
    launches.start()
    ref_labels, _, _, _ = run_facade(scfg, SMALL_ROWS, sfirings, dev, 64)
    half = len(sfirings) // 2
    ckpt = ROOT / "continuous_clustering_tpu_torch" / "build" / "chip_smoke_checkpoint.npz"
    labels = {}
    p1 = make_facade(scfg, SMALL_ROWS, dev, 64)
    collect(p1, labels)
    for f in sfirings[:half]:
        p1.add_firing(f, eye)
    save_state(p1, ckpt)
    p2 = make_facade(scfg, SMALL_ROWS, dev, 64)
    load_state(p2, ckpt)
    ckpt.unlink()
    check(p2.state.device == dev and p2._host_ins is None, "the resume is not on the card")
    collect(p2, labels)
    for f in sfirings[half:]:
        p2.add_firing(f, eye)
    p2.flush()
    got = launches.stop("phase 6")
    common = set(ref_labels) & set(labels)
    check(len(common) > 0.9 * len(ref_labels), "too few points in common after the resume")
    agree = partition_agreement(ref_labels, labels)
    check(agree >= 0.99, f"resume agreement {agree}")
    print(f"phase 6: checkpoint after {half} firings, resumed on device insertion: partition "
          f"agreement {agree:.6f} with the uninterrupted run on {len(common)} points; "
          f"launches {got}")

    # ---- phase 7: the periodic block runner on the throughput scenes --------
    # ``standard`` runs twice from the same state: the checksum must repeat
    for name in bench_setup.SCENES:
        bcfg, bpipe = bench_setup.make_bench_pipe(num_rows=FULL_ROWS, num_cols=n_cols,
                                                  ring_revs=10, batch=B_FIRINGS, nth=1,
                                                  device=dev)
        bfirings, n_points = bench_setup.make_bench_scene(FULL_ROWS, n_cols, name)
        bscene = bench_setup.capture_revolution(bpipe, bfirings, n_cols)
        launches.start()
        runs = [bench_setup.measure_periodic_rate(bcfg, bpipe, bscene, n_cols, n_points, N=1,
                                                  pairs=2, slab_cols=bpipe._slab_W,
                                                  slab_head=bpipe._slab_W1)
                for _ in range(2 if name == "standard" else 1)]
        got = launches.stop(f"phase 7 {name}")
        steps = sum(res["k0"] for res in runs)
        check(got["edge_bits"] == got["window_cc"] == steps,
              f"{name}: launches {got} != steps {steps}")
        check(len({res["checksum"] for res in runs}) == 1,
              f"{name}: checksums of repeated runs differ: {[r['checksum'] for r in runs]}")
        for res in runs:
            check(not res["overflow"] and not res["cc_failed"], f"{name}: overflow or cc_failed")
            total_revs = res["k0"] // res["per_rev"]
            fu = int(res["state"].first_unpublished)
            check(fu > (total_revs - 3) * n_cols,
                  f"{name}: frontier {fu} after {total_revs} revs")
            print(f"phase 7: {card}: periodic runner, scene {name} ({n_points} points/rev, "
                  f"{res['per_rev']} steps/rev, slab included): {res['pts_per_s']:.0f} "
                  f"points/s, {res['ms_per_rev']:.2f} ms/rev, diff_ok {res['diff_ok']}, raw 2N "
                  f"{res['raw_2n_pts_per_s']:.0f} points/s; t1 {res['t1s_ms']} ms, "
                  f"t2 {res['t2s_ms']} ms; frontier {fu} after {total_revs} revs; "
                  f"checksum {res['checksum']}")
        print(f"phase 7: scene {name}: {len(runs)} run(s), checksum "
              f"{runs[0]['checksum']}{' repeated' if len(runs) > 1 else ''}; launches {got}")

    # ---- phase 8: the CC sweep's probe variants -----------------------------
    launches.start()
    results = probe_tool.run(dev)
    got = launches.stop("phase 8", kernels=("sweep_probe",))
    failed = [f"{n}: {r}" for n, r, _ in results if r != "OK"]
    check(not failed, f"probe variants differ from their twins: {failed}")
    max_err["sweep_probe"] = max(e for _, _, e in results)
    n_launch = len(sweep_probe.VARIANTS) * len(probe_tool.UPPERS)
    check(got["sweep_probe"] == n_launch, f"probe launches {got} != {n_launch}")
    bits_np, L_np = probe_tool.probe_inputs(0)
    pbits, pL = torch.from_numpy(bits_np).to(dev), torch.from_numpy(L_np).to(dev)
    pupper = torch.tensor(H + 1, dtype=torch.int32, device=dev)
    probe_t = {}
    for vname in sweep_probe.VARIANTS:
        probe_t[vname] = dict(
            device_ms=median_ms(lambda: sweep_probe.sweep_probe(vname, pbits, pupper, pL),
                                device_only=True),
            host_ms=median_ms(lambda: sweep_probe.sweep_probe(vname, pbits, pupper, pL)),
            plain_ms=median_ms(
                lambda: sweep_probe.sweep_probe_reference(vname, pbits, pupper, pL), n=5),
            bounds=probe_bounds(vname, pL, H + 1))
    slowest = max(probe_t, key=lambda v: probe_t[v]["device_ms"])
    print(f"phase 8: {card}: {len(results)} probe variants equal their twins at upper "
          f"{list(probe_tool.UPPERS)}; launches {got}; at upper {H + 1}, ms device / with "
          "the host's enqueue / plain, bound ms (bytes): "
          + ", ".join(f"{v} {t['device_ms']:.4f} / {t['host_ms']:.4f} / {t['plain_ms']:.3f}, "
                      f"{t['bounds']['bound_ms']:.7f} ({t['bounds']['bytes']})"
                      for v, t in probe_t.items()))

    # ---- phase 9: three sensor streams in one step ---------------------------
    multi_stream_phase(cfg, dev, launches, card, phase5)

    # ---- phase 10: the sensor entry point, from raw packets -------------------
    for name, err in node_phase(dev, launches, card).items():
        max_err[name] = max(max_err[name], err)

    # ---- phase 11: the KITTI evaluation on the card --------------------------
    kitti_phase(dev, launches)

    # ---- phase 12: the column-sharded halo step ------------------------------
    halo_phase(cfg, dev, launches, card)

    # ---- phase 13: device insertion into column-sharded rings ---------------
    sharded_insertion_phase(cfg, dev, launches, card)

    # ---- phase 14: the ground segmentation kernel -----------------------------
    gs = ground_segment_phase(dev, launches, card)
    max_err["ground_segment"] = 0   # the phase raises on any bit that differs

    # ms: CUDA events around the launch as the host issues it, the host's
    # enqueue included; device_ms: the device's time alone
    kit, pt = k2["kitti"], probe_t[slowest]
    timing = {"edge_bits": (kit["k1_host_ms"], kit["k1_ms"], kit["k1_plain_ms"],
                            kit["bounds"]["edge_bits"]),
              "window_cc": (kit["k2_host_ms"], kit["k2_ms"], kit["k2_plain_ms"],
                            kit["bounds"]["window_cc"]),
              "sweep_probe": (pt["host_ms"], pt["device_ms"], pt["plain_ms"], pt["bounds"]),
              "ground_segment": (gs["kitti"]["ms"], gs["kitti"]["device_ms"],
                                 gs["kitti"]["plain_ms"], gs["kitti"]["bounds"])}
    sources = {"edge_bits": ("continuous_clustering_tpu_torch/csrc/edge_bits.cu",
                             "continuous_clustering_tpu/ops/cc_pallas.py:444"),
               "window_cc": ("continuous_clustering_tpu_torch/csrc/window_cc.cu",
                             "continuous_clustering_tpu/ops/cc_pallas.py:202"),
               "sweep_probe": ("continuous_clustering_tpu_torch/csrc/sweep_probe.cu",
                               "scripts/pallas_bisect.py:26"),
               "ground_segment": ("continuous_clustering_tpu_torch/csrc/ground_segment.cu",
                                  None)}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches.total[name],
         "max_abs_err": max_err[name], "ms": timing[name][0], "device_ms": timing[name][1],
         "plain_ms": timing[name][2], "bound_ms": timing[name][3]["bound_ms"],
         "bound_by": timing[name][3]["bound_by"], "library_ms": None}
        for name in ("edge_bits", "window_cc", "sweep_probe", "ground_segment")]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, builds included")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def check_stacked_kernels(windows, k2_inputs, k1_kw, H, V):
    """One K1 launch over the real ``windows`` stacked, and one K2 launch
    over every window of ``k2_inputs`` stacked: each stream's bits, labels,
    converged flag and round count must be its own window's twin's; prints
    each launch's device time.  Returns max |kernel - twin| per kernel."""
    import torch

    from continuous_clustering_tpu_torch.ops import cc_cuda

    fields = ("xw", "yw", "zw", "incw", "active_w", "mad", "wp")
    k1_args = [torch.stack([getattr(w, f) for w in windows.values()]) for f in fields]
    bits = cc_cuda.edge_bits_stacked(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    err = {"edge_bits": 0, "window_cc": 0}
    for s, wname in enumerate(windows):
        err["edge_bits"] = max(err["edge_bits"], max_abs_diff(bits[s], k2_inputs[wname][0]))
        check(torch.equal(bits[s], k2_inputs[wname][0]),
              f"stacked K1: stream {s} ({wname}) differs from its window's twin")
    names = list(k2_inputs)
    k2_args = [torch.stack([k2_inputs[n][0] for n in names]),
               torch.stack([k2_inputs[n][1] for n in names]),
               torch.cat([k2_inputs[n][2] for n in names])]
    lab, ok, rounds = cc_cuda.window_cc_stacked(*k2_args, H=H, V=V)
    torch.cuda.synchronize()
    got_rounds = []
    for s, n in enumerate(names):
        lab_ref, ok_ref, rounds_ref = cc_cuda.window_cc_reference(*k2_inputs[n], H=H, V=V)
        err["window_cc"] = max(err["window_cc"], max_abs_diff(lab[s], lab_ref))
        check(torch.equal(lab[s], lab_ref), f"stacked K2: stream {s} ({n}) labels differ")
        check(bool(ok[s]) == bool(ok_ref) and int(rounds[s]) == int(rounds_ref),
              f"stacked K2: stream {s} ({n}) converged {bool(ok[s])} rounds {int(rounds[s])}, "
              f"twin {bool(ok_ref)} {int(rounds_ref)}")
        got_rounds.append(int(rounds[s]))
    t = {"edge_bits": median_ms(lambda: cc_cuda.edge_bits_stacked(*k1_args, **k1_kw),
                                device_only=True),
         "window_cc": median_ms(lambda: cc_cuda.window_cc_stacked(*k2_args, H=H, V=V),
                                device_only=True)}
    print(f"phase 2: stacked launches: K1 over {list(windows)} in one launch, bits equal each "
          f"window's twin ({t['edge_bits']:.4f} ms device); K2 over {names} in one launch, "
          f"labels, converged {[bool(x) for x in ok.tolist()]} and rounds {got_rounds} equal "
          f"each window's twin ({t['window_cc']:.4f} ms device)")
    return err


def published_labels(steps):
    """Cluster id by point of every column a stream published, from its
    steps' (meta, slab head, slab tail): the columns [fu_old, fu_new) of
    each step's publish slab, joined through the meta's join tables, as the
    facade reads them."""
    import torch

    from continuous_clustering_tpu_torch.models.step import META_FU_NEW, META_FU_OLD, N_META
    from continuous_clustering_tpu_torch.ops.readout import FETCH_ORDER

    row = {f: FETCH_ORDER.index(f) for f in ("uidx_lo", "uidx_hi", "slot")}
    labels = {}
    for meta, head, tail in steps:
        m = meta.cpu().numpy()
        fu_old, fu_new = int(m[META_FU_OLD]), int(m[META_FU_NEW])
        if fu_old < 0 or fu_new <= fu_old:
            continue
        slab = torch.cat([head, tail], dim=2)[:, :, :fu_new - fu_old].cpu().numpy()
        check(slab.shape[2] == fu_new - fu_old, "a step published past its slab")
        uidx = ((slab[row["uidx_hi"]].view(np.uint32).astype(np.uint64) << np.uint64(32))
                | slab[row["uidx_lo"]].view(np.uint32).astype(np.uint64))
        slot = slab[row["slot"]]
        cid = np.where(slot >= 0, m[N_META:].reshape(2, -1)[0][np.maximum(slot, 0)], 0)
        valid = uidx != np.iinfo(np.uint64).max
        labels.update(zip(uidx[valid].tolist(), cid[valid].tolist()))
    return labels


def states_equal(a, b) -> bool:
    """Every field of two states equal (NaN where the other has NaN)."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype.is_floating_point:
            if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def drive_steps(launches, label, step, state, items, keep=()):
    """``state, info = step(state, item)`` over ``items``, the launch
    counters set to 0 just before and read just after; K1 and K2 must
    launch once per item.  Returns (state, infos, ms per step, launches, and
    a copy of the (unsharded) state after each number of steps in
    ``keep``)."""
    import torch

    from continuous_clustering_tpu_torch.ops.state import copy_state

    infos, kept = [], {}
    torch.cuda.synchronize()
    launches.start()
    t0 = time.perf_counter()
    for k, item in enumerate(items):
        state, info = step(state, item)
        infos.append(info)
        if k + 1 in keep:
            kept[k + 1] = copy_state(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(items) * 1e3
    got = launches.stop(label)
    check(got["edge_bits"] == got["window_cc"] == len(items),
          f"{label}: launches {got}, {len(items)} steps")
    return state, infos, ms, got, kept


def check_same_infos(label, infos, refs):
    """Every step's meta, slab and slab tail equal the reference run's."""
    import torch

    check(len(infos) == len(refs), f"{label}: {len(infos)} steps, {len(refs)}")
    for k, (a, b) in enumerate(zip(infos, refs)):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label}: step {k} meta or slab differs from the unsharded step")


def multi_stream_phase(cfg, dev, launches, card, phase5, n_streams=3, n_rev=2):
    """Phase 9: ``n_streams`` sensors of the KITTI configuration, each its
    own scene, through the multi-sensor step on the card; then each stream
    alone through ``pipeline_step`` on the same batches."""
    import torch

    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.models.step import (META_CC_FAILED, META_OVERFLOW,
                                                             EgoCalibration, pipeline_step)
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.insertion import make_firing_batch
    from continuous_clustering_tpu_torch.ops.state import copy_state, init_state
    from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                       stacked_init)

    n_cols = cfg.range_image.num_columns
    eye = np.eye(4)
    streams = [kitti_stream(FULL_ROWS, n_cols, n_rev, seed=5 + s, num_boxes=14 + s)
               for s in range(n_streams)]
    n_steps = -(-len(streams[0]) // B_FIRINGS)
    batches = [[make_firing_batch(f[k * B_FIRINGS:(k + 1) * B_FIRINGS],
                                  [eye] * len(f[k * B_FIRINGS:(k + 1) * B_FIRINGS]),
                                  B_FIRINGS, FULL_ROWS, dev) for k in range(n_steps)]
               for f in streams]
    points = sum(int(np.isfinite(f["xyz"][:, 0]).sum()) for st in streams for f in st)
    # the facade's step width, publish slab and calibration
    ref = make_facade(cfg, FULL_ROWS, dev, B_FIRINGS, insertion="device")
    B, W, W1, calib = ref._batch_B, ref._slab_W, ref._slab_W1, ref._make_calib()
    scalib = EgoCalibration(*[torch.stack([t] * n_streams) for t in calib])
    sbatches = [stack_batches([batches[s][k] for s in range(n_streams)]) for k in range(n_steps)]
    run = make_sharded_step(cfg, B, device=dev, slab_cols=W, slab_head=W1)
    state = stacked_init(cfg, FULL_ROWS, n_streams, dev)
    ring_mb = sum(t.numel() * t.element_size() for t in vars(state).values()) / 1e6

    infos = []
    torch.cuda.synchronize()
    launches.start()
    t0 = time.perf_counter()
    for k in range(n_steps):
        if k == n_steps - 1:
            before_last = copy_state(state)
        state, info = run(state, sbatches[k], scalib)
        infos.append(info)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = launches.stop("phase 9")
    check(got["edge_bits"] == got["window_cc"] == n_steps,
          f"launches {got}: K1 and K2 must launch once per step of {n_steps}")
    metas = torch.stack([i.meta for i in infos]).cpu()       # (steps, streams, lanes)
    check(not bool(metas[:, :, [META_OVERFLOW, META_CC_FAILED]].any()), "overflow or cc_failed")

    # one step under the profiler: device kernels launched, device busy time
    launches.start()
    try:
        prof = device_profile(lambda: run(before_last, sbatches[-1], scalib))
    except RuntimeError as e:  # the profiler is an observer: its failure fails no check
        print(f"phase 9: torch.profiler failed: {e}")
        prof = None
    launches.stop("phase 9 profile")
    del before_last

    single_dt, agree = 0.0, []
    for s in range(n_streams):
        st, steps = init_state(cfg, FULL_ROWS, dev), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n_steps):
            st, info = pipeline_step(cfg, st, batches[s][k], calib, B, W, W1)
            steps.append(info)
        torch.cuda.synchronize()
        single_dt += time.perf_counter() - t0
        for k, info in enumerate(steps):
            check(torch.equal(info.meta.cpu(), metas[k, s]),
                  f"stream {s}, step {k}: meta differs from the stream run alone")
        check(states_equal(st, type(st)(**{n: t[s] for n, t in vars(state).items()})),
              f"stream {s}: state differs from the stream run alone")
        alone = published_labels([(i.meta, i.slab, i.slab_ext) for i in steps])
        together = published_labels([(i.meta[s], i.slab[s], i.slab_ext[s]) for i in infos])
        check(alone.keys() == together.keys() and len(alone) > 10000,
              f"stream {s}: {len(together)} points published, {len(alone)} alone")
        agree.append(partition_agreement(alone, together))
        check(agree[-1] == 1.0, f"stream {s}: partition agreement {agree[-1]}")
    prof_txt = ("profiler saw no device time" if prof is None else
                f"one step under the profiler: {prof[0]} device kernels, device busy "
                f"{prof[1]:.2f} of {prof[2]:.2f} ms ({100 * prof[1] / prof[2]:.2f} %)")
    print(f"phase 9: {card}: {n_streams} streams of {FULL_ROWS} x {n_cols} ({n_rev} revolutions "
          f"each, firing batch {B_FIRINGS}, {ring_mb:.0f} MB of state) in one step: {points} "
          f"points in {dt:.3f} s = {points / dt:.0f} points/s, {n_steps} steps, "
          f"{dt / n_steps * 1e3:.2f} ms/step; launches {got}; {prof_txt}")
    print(f"phase 9: the same streams one after another through pipeline_step: "
          f"{points / single_dt:.0f} points/s, {single_dt / (n_steps * n_streams) * 1e3:.2f} ms "
          f"per stream step; phase 5 (one stream, facade): {phase5['pts_s']:.0f} points/s, "
          f"{phase5['ms_step']:.2f} ms/step; every stream's meta and state equal its run "
          f"alone, published partition agreement {agree}")


def run_node(desc, packets, device):
    """Feed ``packets`` to the node of launch description ``desc`` on
    ``device``; returns (cluster id by (column, row) of every published
    instance column, (size, stamp) of every published cluster, node, wall
    seconds)."""
    import torch

    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.tools.sensor_packets import feed

    node = launch.make_node(desc, device=device)
    labels, clusters = {}, []

    def on_instance(cloud):
        ok = np.isfinite(cloud["x"])
        labels.update(zip(zip(cloud["global_column_index"][ok].tolist(),
                              cloud["row_index"][ok].tolist()), cloud["id"][ok].tolist()))

    node.publish_instance_columns = on_instance
    node.publish_cluster = lambda pts, stamp: clusters.append((len(pts), int(stamp)))
    t0 = time.perf_counter()
    feed(node, packets)
    if node.device.type == "cuda":
        torch.cuda.synchronize()
    return labels, clusters, node, time.perf_counter() - t0


def check_node_window(pipe, card):
    """K1 and K2 against their twins, and timed, on the last association
    window of a node's stream (its rows and step width); returns max
    |kernel - twin| per kernel."""
    import torch

    from continuous_clustering_tpu_torch.ops import cc_cuda
    from continuous_clustering_tpu_torch.ops.association import window_arrays

    cfg, state, B = pipe._config, pipe.state, pipe._batch_B
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    win = window_arrays(cfg, state, state.first_unfinished - B,
                        torch.tensor(B, dtype=torch.int32, device=state.x.device), B)
    max_d = np.float32(cfg.clustering.max_distance)
    kw = dict(H=H, V=V, max_d2=float(max_d * max_d))
    args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
    bits, bits_ref = cc_cuda.edge_bits(*args, **kw), cc_cuda.edge_bits_reference(*args, **kw)
    torch.cuda.synchronize()
    err = {"edge_bits": max_abs_diff(bits, bits_ref)}
    check(torch.equal(bits, bits_ref), f"node window: K1 bits differ (max |diff| {err})")
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    rounds, err["window_cc"] = check_window_cc("node window", bits, win.L0, max_wp, H, V, True)
    k1 = median_ms(lambda: cc_cuda.edge_bits(*args, **kw), device_only=True)
    k2 = median_ms(lambda: cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V), device_only=True)
    b = kernel_bounds(win, bits, max_wp, rounds, H, V)
    print(f"phase 10: {card}: the node's last window R={win.active_w.shape[0]} "
          f"WCOL={win.active_w.shape[1]}, {int(win.active_w.sum())} active cells: K1 bits equal, "
          f"{k1:.4f} ms device, bound {b['edge_bits']['bound_ms']:.6f} ms "
          f"({b['edge_bits']['bound_by']}); K2 labels, converged and rounds ({rounds}) equal, "
          f"{k2:.4f} ms device, bound {b['window_cc']['bound_ms']:.6f} ms "
          f"({b['window_cc']['bound_by']})")
    return err


def node_phase(dev, launches, card, n_rev=2):
    """Phase 10: the roof VLS-128 and both OS-32 presets from raw packets
    on the card against the CPU, then the latency bench on the card.
    Returns max |kernel - twin| per kernel of the node windows' checks."""
    import tempfile

    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.tools import latency_bench
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp

    t_phase = time.perf_counter()
    max_err = {"edge_bits": 0, "window_cc": 0}
    with tempfile.TemporaryDirectory() as tmp:
        info = sp.os32_sensor_info()
        meta = Path(tmp) / "os32_sensor_info.json"
        meta.write_text(json.dumps(info))
        descs = launch.demo_touareg(os32_metadata=str(meta))
        check([d.name for d in descs] == ["vls128_roof", "os32_left", "os32_right"],
              f"demo_touareg: {[d.name for d in descs]}")
        os32_inc = np.deg2rad(np.asarray(info["beam_altitude_angles"]))
        for k, desc in enumerate(descs):
            cols = desc.config.range_image.num_columns
            if desc.sensor_manufacturer == "velodyne":
                rows = desc.sensor_kwargs["num_lasers"]
                frames = sp.scene_frames(rows, cols, n_rev, sp.velodyne_inclinations(rows),
                                         seed=7, num_boxes=16)
                packets = sp.velodyne_packets(frames)
            else:
                rows = info["data_format"]["pixels_per_column"]
                frames = sp.scene_frames(rows, cols, n_rev, os32_inc, seed=8 + k, num_boxes=12,
                                         spread=20.0)
                packets = sp.ouster_legacy_packets(frames, info)
            points = sum(int(np.isfinite(f[:, :, 0]).sum()) for f in frames)
            launches.start()
            labels, clusters, node, dt = run_node(desc, packets, dev)
            got = launches.stop(f"phase 10 {desc.name}")
            pipe = node.clustering
            check(node.sensor_input.pending_packets() == 0,
                  f"{desc.name}: packets left in the decode queue after flush")
            check(not desc.config.general.is_single_threaded and
                  node.sensor_input._offload is not None,
                  f"{desc.name}: the preset runs asynchronous with a decode thread")
            ring_mb = sum(t.numel() * t.element_size() for t in vars(pipe.state).values()) / 1e6
            facade = pipe.stats.summary().get("device_step", {"count": 0, "total_s": 0.0})
            t_cpu = time.perf_counter()
            cpu_labels, cpu_clusters, _, _ = run_node(desc, packets, "cpu")
            t_cpu = time.perf_counter() - t_cpu
            check(len(cpu_labels) > 5000 and labels.keys() == cpu_labels.keys(),
                  f"{desc.name}: {len(labels)} points published on the card, "
                  f"{len(cpu_labels)} on the CPU")
            agree = partition_agreement(cpu_labels, labels)
            check(agree == 1.0, f"{desc.name}: card vs CPU partition agreement {agree}")
            check(clusters == cpu_clusters and len(clusters) > 0,
                  f"{desc.name}: {len(clusters)} clusters on the card, {len(cpu_clusters)} "
                  "on the CPU, or their sizes or stamps differ")
            print(f"phase 10: {card}: {desc.name} ({desc.sensor_manufacturer}, {rows} x {cols}, "
                  f"{len(packets)} packets of {n_rev} revolutions, decode thread, async, "
                  f"{ring_mb:.0f} MB of ring state): {dt / n_rev * 1e3:.2f} ms per revolution, "
                  f"{points / dt:.0f} points/s, {facade['count']} batches taking "
                  f"{facade['total_s']:.3f} s in the facade (host insertion, the step, the "
                  f"previous step's meta read) of {dt:.3f} s; {len(clusters)} clusters; "
                  f"launches {got}; CPU leg "
                  f"({t_cpu:.1f} s): partition agreement {agree} on {len(labels)} points, "
                  "clusters and stamps equal")
            if desc.sensor_manufacturer == "velodyne":
                for name, err in check_node_window(pipe, card).items():
                    max_err[name] = max(max_err[name], err)
    launches.start()
    lat = latency_bench.main(["--device", "cuda", "--revolutions", "2"])
    got = launches.stop("phase 10 latency bench")
    check(lat["clusters"] > 0, "the latency bench published no cluster")
    print(f"phase 10: {card}: latency bench ({lat['rows']} x {lat['columns']}, batch "
          f"{lat['batch']}, {lat['columns_per_second']:.0f} columns/s, 2 revolutions): publish "
          f"latency p50 {lat['p50_ms']:.2f} / p95 {lat['p95_ms']:.2f} / p99 "
          f"{lat['p99_ms']:.2f} ms (from the pacing, backlog included: p50 "
          f"{lat['schedule_p50_ms']:.2f} / p95 {lat['schedule_p95_ms']:.2f} / p99 "
          f"{lat['schedule_p99_ms']:.2f} ms), {lat['deadline_misses']} deadline misses, "
          f"{lat['clusters']} clusters; streamed in {lat['stream_s']:.3f} s for "
          f"{lat['real_time_s']:.3f} s of sensor time; launches {got}")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s in all")
    return max_err


def few_rows_phase(scfg, dev):
    """Phase 3's 8 x 220 leg: host insertion below 15 rows (fields and
    scalars in one upload, the pose rows in a second) on the card against
    the same stream on the CPU.  Returns a line of text."""
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.evaluation.synthetic import (
        frame_to_firings, make_scene, raycast_frame)
    from continuous_clustering_tpu_torch.ops.ingest import N_SPLIT_PLANES

    scene = make_scene(num_boxes=8, seed=4, spread=20.0)
    firings = []
    for f in range(2):
        xyz, _ = raycast_frame(scene, num_rows=FEW_ROWS, num_columns=SMALL_COLS, seed=4 + f)
        firings += frame_to_firings(xyz, frame_index=f)
    labels, ground, clusters, pipe = run_facade(scfg, FEW_ROWS, firings, dev, 64)
    check(pipe._staging.shape[0] == N_SPLIT_PLANES, "8 rows: not the two-buffer staging")
    c_labels, c_ground, c_clusters, _ = run_facade(scfg, FEW_ROWS, firings, "cpu", 64)
    check(labels.keys() == c_labels.keys() and len(labels) > 300,
          f"8 rows: {len(labels)} points published on the card, {len(c_labels)} on the CPU")
    agree = partition_agreement(c_labels, labels)
    check(agree == 1.0, f"8 rows: card vs CPU partition agreement {agree}")
    check(ground == c_ground, "8 rows: ground labels differ from the CPU's")
    check(clusters and sorted(clusters) == sorted(c_clusters),
          f"8 rows: cluster sizes {sorted(clusters)} vs CPU {sorted(c_clusters)}")
    return (f"host insertion at {FEW_ROWS} x {SMALL_COLS} (two uploads a step): partition "
            f"agreement with the CPU {agree} on {len(labels)} points, ground labels and "
            f"{len(clusters)} cluster sizes equal")


def kitti_phase(dev, launches, n_frames=3, n_cols=2200):
    """Phase 11: the KITTI evaluation harness on a synthetic sequence at
    64 x 2200 on the card against the CPU, then the HTML viewer."""
    import base64
    import contextlib
    import io
    import os
    import re
    import tempfile

    import torch

    from continuous_clustering_tpu_torch.tools import gt_label_generator, html_viewer
    from continuous_clustering_tpu_torch.tools.kitti_demo import KittiDemo
    from continuous_clustering_tpu_torch.tools.make_synthetic_dataset import write_sequence
    from continuous_clustering_tpu_torch.utils.platform import describe_device

    class RecordingDemo(KittiDemo):
        """The demo, recording each published point's cluster id."""

        partition: dict

        def _on_finished_columns(self, pipe, from_gcol, to_gcol):
            cloud = pipe.get_columns(from_gcol, to_gcol)
            ok = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
            self.partition.update(zip(cloud["globally_unique_point_index"][ok].tolist(),
                                      cloud["id"][ok].tolist()))
            super()._on_finished_columns(pipe, from_gcol, to_gcol)

    t_phase = time.perf_counter()
    desc = describe_device(dev)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "kitti"
        write_sequence(root, "00", num_frames=n_frames, num_boxes=10, seed=0,
                       num_rows=FULL_ROWS, num_columns=n_cols, speed_mps=5.0)
        with contextlib.redirect_stdout(io.StringIO()):
            gt_label_generator.main([str(root), "00"])
        os.chdir(tmp)
        try:
            runs = {}
            for name, device in (("card", dev), ("cpu", "cpu")):
                demo = RecordingDemo(evaluate=True, delay_between_columns=0, device=device,
                                     num_rows=FULL_ROWS, num_columns=n_cols)
                demo.partition = {}
                if name == "card":
                    launches.start()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    demo.run(root, ["00"])
                if name == "card":
                    torch.cuda.synchronize()
                    got = launches.stop("phase 11 kitti demo")
                    steps = demo.last_pipe.n_steps
                    check(demo.last_pipe.state.x.device == dev
                          and demo.last_pipe._host_ins is not None,
                          "phase 11: the demo did not run host insertion on the card")
                    check(got["edge_bits"] == got["window_cc"] == steps,
                          f"phase 11: launches {got} != association steps {steps}")
                runs[name] = (demo, time.perf_counter() - t0)
        finally:
            os.chdir(cwd)
        (gpu, dt), (cpu, t_cpu) = runs["card"], runs["cpu"]
        frames = [dataclasses.astuple(r) for r in gpu.evaluation.per_sequence[-1]]
        cpu_frames = [dataclasses.astuple(r) for r in cpu.evaluation.per_sequence[-1]]
        check(len(frames) == n_frames and frames == cpu_frames,
              f"phase 11: per-frame results on the card {frames} vs the CPU {cpu_frames}")
        agree, n_common = agreement_with_cpu(gpu.partition, cpu.partition, "phase 11")
        table = gpu.evaluation.generate_evaluation_results()
        check(table == cpu.evaluation.generate_evaluation_results(),
              "phase 11: the result tables differ")
        pooled = [line for line in table.splitlines() if "All (**Ours**)" in line][0]
        recall = float(pooled.split("|")[2].split("/")[0])
        check(recall > 90.0, f"phase 11: ground recall {recall}")
        cols = n_frames * n_cols
        facade = gpu.last_pipe.stats.summary().get("device_step", {"count": 0, "total_s": 0.0})
        print(f"phase 11: {desc['device']}, power limit {desc['power_limit']}: KITTI demo on "
              f"{n_frames} synthetic frames of {FULL_ROWS} x {n_cols} (ego 5 m/s, host insertion, "
              f"firing batch {gpu.firing_batch}): {dt:.3f} s, {dt / n_frames:.3f} s per frame, "
              f"{cols / dt:.0f} columns/s, {steps} steps, {facade['count']} batches taking "
              f"{facade['total_s']:.3f} s in the facade; launches {got}; CPU leg {t_cpu:.1f} s "
              f"({t_cpu / n_frames:.3f} s per frame): per-frame (tp, fp, fn, tn, use, ose) "
              f"equal, partition agreement {agree} on {n_common} points")
        print(f"phase 11: pooled row {pooled}")
        out = Path(tmp) / "viewer.html"
        launches.start()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = html_viewer.main([str(out), "--rows", str(SMALL_ROWS), "--columns",
                                   str(SMALL_COLS), "--device", str(dev)])
        torch.cuda.synchronize()
        got = launches.stop("phase 11 html viewer")
        data = json.loads(re.search(r"const DATA = (\{.*?\});\n", out.read_text(), re.S).group(1))
        n_pts = len(base64.b64decode(data["xyz_b64"])) // 12
        n_clusters = data["kinds"].count("cluster")
        check(rc == 0 and data["n"] == n_pts > 0 and n_clusters > 0,
              f"phase 11: html viewer rc {rc}, {data['n']} points, {n_clusters} clusters")
        print(f"phase 11: html viewer on the card at {SMALL_ROWS} x {SMALL_COLS}: {n_pts} points, "
              f"{n_clusters} clusters in its payload; launches {got}")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s in all")


def halo_phase(cfg, dev, launches, card, n_rev=3):
    """Phase 12: the column-sharded halo step (``parallel/halo.py``) on the
    card, every shard on ``dev``.  The phase-4 scene at full width (ring of
    10 revolutions, firing batch 384) is captured once with the host
    insertion on the card and run through the unsharded
    ``pipeline_step_block`` and through the halo step with nsp 4, both with
    the publish slab (W 128, head 64); then with nsp 8 over the first
    revolution; then two streams over dp 2 x sp 4 in one stacked step.  Every
    ring field, the slot table, the scalars and every step's meta, slab and
    slab tail must equal the unsharded run's, and K1 and K2 must launch once
    per step (once for both streams when stacked)."""
    import torch

    from continuous_clustering_tpu_torch.models.step import pipeline_step_block
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.state import init_state
    from continuous_clustering_tpu_torch.parallel.halo import make_halo_sharded_step
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree
    from continuous_clustering_tpu_torch.parallel.multi_sensor import stacked_init
    from continuous_clustering_tpu_torch.tools import bench_setup

    t_phase = time.perf_counter()
    n_cols, rc = cfg.range_image.num_columns, cfg.ring_buffer_max_columns
    W, W1 = 128, 64
    hsg = torch.tensor(bench_setup.HSG, device=dev)

    def capture(seed, num_boxes):
        """(steps of every revolution, steps of the first, step width B)."""
        pipe = make_facade(cfg, FULL_ROWS, dev, B_FIRINGS)
        firings = kitti_stream(FULL_ROWS, n_cols, n_rev, seed=seed, num_boxes=num_boxes)
        steps, first = [], 0
        for r in range(n_rev):
            blocks, segps = bench_setup._insert_revolution(
                pipe, firings[r * n_cols:(r + 1) * n_cols], n_cols)
            steps += zip(blocks, segps)
            first = first or len(steps)
        return steps, first, pipe._batch_B

    def drive(label, step, state, steps):
        """``state, info = step(state, block, seg_poses)`` over ``steps``;
        returns (state, infos, ms per step, launches)."""
        return drive_steps(launches, f"phase 12 {label}", lambda s, bp: step(s, *bp), state,
                           steps)[:4]

    def same_infos(label, infos, refs):
        check_same_infos(f"phase 12 {label}", infos, refs)

    steps, first, B = capture(5, 14)

    def unsharded(slab):
        return lambda s, b, p: pipeline_step_block(cfg, s, b, p, hsg, B, *slab)

    def fresh():
        return init_state(cfg, FULL_ROWS, dev)

    ref, ref_infos, ms_ref, got_ref = drive("unsharded", unsharded((W, W1)), fresh(), steps)
    mesh4 = make_mesh(devices=[dev] * 4, dp=1)
    run4 = make_halo_sharded_step(cfg, mesh4, B, slab_cols=W, slab_head=W1)
    sh4, infos4, ms4, got4 = drive("halo nsp 4", lambda s, b, p: run4(s, b, p, hsg),
                                   shard_pytree(mesh4, fresh(), stacked=False), steps)
    same_infos("nsp 4", infos4, ref_infos)
    check(states_equal(gather_state(sh4), ref), "phase 12 nsp 4: state differs")
    check(int(ref.ring_start) > 0 and not bool(ref.overflow), "phase 12: the clear never ran")
    print(f"phase 12: {card}: halo step at {FULL_ROWS} x {n_cols} (ring {rc} columns, B {B}, "
          f"slab {W}/{W1}, {n_rev} revolutions, {len(steps)} steps): nsp 4 {ms4:.2f} ms/step vs "
          f"the unsharded step {ms_ref:.2f} ms/step; every ring field, the slot table, the "
          f"scalars and every step's meta, slab and tail equal; launches halo {got4}, "
          f"unsharded {got_ref}")
    del sh4, ref

    mesh8 = make_mesh(devices=[dev] * 8, dp=1)
    run8 = make_halo_sharded_step(cfg, mesh8, B)
    ref8, ref8_infos, ms_ref8, _ = drive("unsharded first revolution", unsharded((0, 0)),
                                         fresh(), steps[:first])
    sh8, infos8, ms8, got8 = drive("halo nsp 8", lambda s, b, p: run8(s, b, p, hsg),
                                   shard_pytree(mesh8, fresh(), stacked=False), steps[:first])
    same_infos("nsp 8", infos8, ref8_infos)
    check(states_equal(gather_state(sh8), ref8), "phase 12 nsp 8: state differs")
    print(f"phase 12: {card}: nsp 8 over the first revolution ({first} steps, no slab): "
          f"{ms8:.2f} ms/step vs the unsharded step {ms_ref8:.2f} ms/step; state and meta "
          f"equal; launches {got8}")
    del sh8, ref8

    steps2, _, _ = capture(6, 15)
    n = min(len(steps), len(steps2))
    refs, ms_one = [], 0.0
    for s, st_steps in enumerate((steps, steps2)):
        final, infos, ms, _ = drive(f"unsharded stream {s}", unsharded((0, 0)), fresh(),
                                    st_steps[:n])
        refs.append((final, infos))
        ms_one += ms / 2
    mesh2 = make_mesh(devices=[dev] * 8)
    run2 = make_halo_sharded_step(cfg, mesh2, B, stacked=True)
    both = [(stack_batches([steps[k][0], steps2[k][0]]), stack_batches([steps[k][1], steps2[k][1]]))
            for k in range(n)]
    hsg2 = torch.stack([hsg, hsg])
    st, infos_st, ms_st, got_st = drive(
        "halo stacked", lambda s, b, p: run2(s, b, p, hsg2),
        shard_pytree(mesh2, stacked_init(cfg, FULL_ROWS, 2, dev), stacked=True), both)
    full = gather_state(st)
    for s, (final, infos) in enumerate(refs):
        same_infos(f"stacked stream {s}", [type(i)(*[t[s] for t in i]) for i in infos_st], infos)
        check(states_equal(type(final)(**{f: t[s] for f, t in vars(full).items()}), final),
              f"phase 12 stacked: stream {s} state differs from its unsharded run")
    print(f"phase 12: {card}: two streams over dp 2 x sp 4 on one card, stacked: {ms_st:.2f} "
          f"ms/step ({n} steps) vs {ms_one:.2f} ms per unsharded stream step; each stream's "
          f"state and meta equal its unsharded run; launches {got_st} (once per stacked step)")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all")


def sharded_insertion_phase(cfg, dev, launches, card, n_rev=1, sp8_steps=3):
    """Phase 13: the device-insertion multi-sensor step on a dp 2 x sp 4 mesh,
    every shard on ``dev`` (``make_sharded_step(mesh=...)``,
    ``parallel/halo.py::insertion_sharded_step``): two KITTI-configuration
    streams (phase 12's scenes, ring of 10 revolutions, 5,500 columns a
    shard), firing batch 384, slab 128 / 64, over the first revolution,
    against the unsharded ``make_sharded_step(device=dev)`` on the same
    stacked batches; then dp 1 x sp 8 over the first ``sp8_steps`` steps.
    Every step's meta, slab and slab tail and, after the run, every ring
    field, the slot table and the scalars must be equal; K1 and K2 launch
    once a step.  One step of each is counted under the profiler."""
    import torch

    from continuous_clustering_tpu_torch.models.step import (META_CC_FAILED, META_NUM_NEW,
                                                             META_OVERFLOW, EgoCalibration)
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.insertion import make_firing_batch
    from continuous_clustering_tpu_torch.ops.state import copy_state
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree
    from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                       stacked_init)

    t_phase = time.perf_counter()
    n_cols, rc = cfg.range_image.num_columns, cfg.ring_buffer_max_columns
    eye = np.eye(4)
    streams = [kitti_stream(FULL_ROWS, n_cols, n_rev, seed=5, num_boxes=14),
               kitti_stream(FULL_ROWS, n_cols, n_rev, seed=6, num_boxes=15)]
    n_steps = -(-len(streams[0]) // B_FIRINGS)
    ref = make_facade(cfg, FULL_ROWS, dev, B_FIRINGS, insertion="device")
    B, calib, (W, W1) = ref._batch_B, ref._make_calib(), (128, 64)
    scalib = EgoCalibration(*[torch.stack([t] * 2) for t in calib])
    sbatches = [stack_batches([make_firing_batch(f[k * B_FIRINGS:(k + 1) * B_FIRINGS],
                                                 [eye] * len(f[k * B_FIRINGS:(k + 1) * B_FIRINGS]),
                                                 B_FIRINGS, FULL_ROWS, dev) for f in streams])
                for k in range(n_steps)]

    def drive(label, run, state, steps, keep=()):
        return drive_steps(launches, f"phase 13 {label}", lambda s, b: run(s, b, scalib),
                           state, steps, keep)

    def same(label, infos, refs, state, want):
        check_same_infos(f"phase 13 {label}", infos, refs)
        check(states_equal(gather_state(state), want), f"phase 13 {label}: state differs")

    def profile(run, state, batch):
        launches.start()
        try:
            prof = device_profile(lambda: run(state, batch, scalib))
        except RuntimeError as e:  # the profiler is an observer: its failure fails no check
            print(f"phase 13: torch.profiler failed: {e}")
            prof = None
        launches.stop("phase 13 profile")
        return "no device time" if prof is None else f"{prof[0]} device kernels"

    one_run = make_sharded_step(cfg, B, device=dev, slab_cols=W, slab_head=W1)
    one = stacked_init(cfg, FULL_ROWS, 2, dev)
    state_mb = sum(t.numel() * t.element_size() for t in vars(one).values()) / 1e6
    one, refs, ms_one, got_one, kept = drive("unsharded", one_run, one, sbatches,
                                             keep=(sp8_steps, n_steps - 1))
    one_early, one_before = kept[sp8_steps], kept[n_steps - 1]
    metas = torch.stack([i.meta for i in refs]).cpu()
    check(not bool(metas[:, :, [META_OVERFLOW, META_CC_FAILED]].any()), "overflow or cc_failed")
    check(int(metas[:, :, META_NUM_NEW].sum()) > 0, "phase 13: nothing was published")

    mesh = make_mesh(devices=[dev] * 8)
    check(mesh.shape == {"dp": 2, "sp": 4}, f"phase 13: mesh {mesh.shape}")
    run = make_sharded_step(cfg, B, slab_cols=W, slab_head=W1, mesh=mesh)
    sh = shard_pytree(mesh, stacked_init(cfg, FULL_ROWS, 2, dev), stacked=True)
    sh, infos, ms_sh, got_sh, _ = drive("dp 2 x sp 4", run, sh, sbatches)
    same("dp 2 x sp 4", infos, refs, sh, one)
    check(all(t.shape[-1] == rc // 4 for row in sh.shards for part in row
              for t in (part.x, part.distance, part.slot)), "phase 13: a shard is not rc / 4 wide")
    prof_sh = profile(run, shard_pytree(mesh, one_before, stacked=True), sbatches[-1])
    prof_one = profile(one_run, copy_state(one_before), sbatches[-1])
    print(f"phase 13: {card}: device insertion, 2 streams of {FULL_ROWS} x {n_cols} (ring {rc} "
          f"columns, {rc // 4} a shard, B {B}, slab {W}/{W1}, {state_mb:.0f} MB of state for "
          f"both, {n_rev} revolution, {n_steps} steps) on dp 2 x sp 4: {ms_sh:.2f} ms/step vs "
          f"the unsharded step {ms_one:.2f} ms/step; every step's meta, slab and tail and every "
          f"ring field, the slot table and the scalars equal; launches sharded {got_sh}, "
          f"unsharded {got_one}; one step under the profiler: sharded {prof_sh}, unsharded "
          f"{prof_one}")
    del sh, one_before

    mesh8 = make_mesh(devices=[dev] * 8, dp=1)
    run8 = make_sharded_step(cfg, B, slab_cols=W, slab_head=W1, mesh=mesh8)
    sh8 = shard_pytree(mesh8, stacked_init(cfg, FULL_ROWS, 2, dev), stacked=True)
    sh8, infos8, ms8, got8, _ = drive("dp 1 x sp 8", run8, sh8, sbatches[:sp8_steps])
    same("dp 1 x sp 8", infos8, refs[:sp8_steps], sh8, one_early)
    print(f"phase 13: {card}: dp 1 x sp 8 ({rc // 8} columns a shard) over the first "
          f"{sp8_steps} steps: {ms8:.2f} ms/step; state and meta equal; launches {got8}")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all")


def copy_state(state):
    """A copy of every tensor of ``state`` (the ring is updated in place)."""
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


def ground_segment_bound(state, seg_in, B: int, fog: bool) -> dict:
    """Least time of one segmentation step: each ring cell of the segmented
    columns read once (x, y, z, distance, inclination, gcol, and intensity
    with fog filtering) and written once (both labels, is_ignored,
    inclination, gcol, and cont_az of the NaN cells), the per-column poses
    (15 f32) and the inclination carry in and out.  No operation bound: a
    few tens of f32 operations a cell are below the bytes' time."""
    import torch

    from continuous_clustering_tpu_torch.ops.state import ring_read

    R, n = state.num_rows, int(seg_in.n_cols)
    dist = ring_read(state.distance, seg_in.gcol0 % state.ring_cols, B)[:, :n]
    cells = R * n
    nbytes = cells * (6 * 4 + 4 * fog + 2 * 4 + 1 + 2 * 4) + int(torch.isnan(dist).sum()) * 4
    return bound(nbytes + B * 15 * 4 + 2 * R * 4, 0)


def ground_segment_phase(dev, launches, card):
    """Phase 14: the ground segmentation kernel against its twin on the card
    at the main path's shapes, the KITTI configuration (64 x 2200, firing
    batch 384, B = 416) and the VLS-128 roof preset (128 x 1700, batch 256,
    B = 288).  A revolution of each scene is host-inserted on the card; the
    steps before its middle run through ``pipeline_step_block``; the middle
    block is ingested and then segmented from two copies of one state, by
    the kernel and by the twin: every state field equal, bit for bit.
    Returns per shape the kernel's CUDA-event medians (with the host's
    enqueue, and the device's alone), the twin's, and the byte bound."""
    import torch

    from continuous_clustering_tpu_torch.config import kitti_config, vls128_roof_config
    from continuous_clustering_tpu_torch.models.step import (block_segment_inputs,
                                                             pipeline_step_block)
    from continuous_clustering_tpu_torch.ops.ground_segmentation import (
        ground_segment_columns, ground_segment_columns_reference)
    from continuous_clustering_tpu_torch.ops.ingest import ingest_columns
    from continuous_clustering_tpu_torch.ops.state import init_state
    from continuous_clustering_tpu_torch.tools import bench_setup

    hsg = torch.tensor(bench_setup.HSG, device=dev)
    out = {}
    for name, cfg, rows, batch in (("kitti", kitti_config(), FULL_ROWS, B_FIRINGS),
                                   ("vls128", vls128_roof_config(), 128, 256)):
        n_cols = cfg.range_image.num_columns
        pipe = make_facade(cfg, rows, dev, batch)
        blocks, segps = bench_setup._insert_revolution(
            pipe, kitti_stream(rows, n_cols, 1), n_cols)
        B, mid = pipe._batch_B, len(blocks) // 2
        state = init_state(cfg, rows, dev)
        launches.start()
        for blk, segp in zip(blocks[:mid], segps[:mid]):
            state, _ = pipeline_step_block(cfg, state, blk, segp, hsg, B)
        got = launches.stop(f"phase 14 {name}", kernels=("ground_segment",))
        check(got["ground_segment"] == mid, f"phase 14 {name}: {got} launches over {mid} steps")
        state = ingest_columns(cfg, state, blocks[mid], B)
        seg_in = block_segment_inputs(blocks[mid], segps[mid], hsg)
        kern = ground_segment_columns(cfg, copy_state(state), seg_in, B)
        plain = ground_segment_columns_reference(cfg, copy_state(state), seg_in, B)
        torch.cuda.synchronize()
        differ = [f.name for f in dataclasses.fields(plain)
                  if not torch.equal(*(t.view(torch.int32) if t.dtype == torch.float32 else t
                                       for t in (getattr(kern, f.name), getattr(plain, f.name))))]
        check(not differ, f"phase 14 {name}: the kernel differs from the twin in {differ}")
        scratch = copy_state(state)
        t = dict(
            device_ms=median_ms(lambda: ground_segment_columns(cfg, scratch, seg_in, B),
                                device_only=True),
            ms=median_ms(lambda: ground_segment_columns(cfg, scratch, seg_in, B)),
            plain_ms=median_ms(lambda: ground_segment_columns_reference(cfg, scratch, seg_in, B),
                               n=5),
            bounds=ground_segment_bound(state, seg_in, B,
                                        cfg.ground_segmentation.fog_filtering_enabled))
        out[name] = t
        print(f"phase 14: {card}: {name} {rows} x {B} (n_cols {int(seg_in.n_cols)}), step "
              f"{mid}: kernel equals the twin in every field; kernel {t['ms']:.4f} ms with "
              f"the enqueue, {t['device_ms']:.4f} device; twin {t['plain_ms']:.2f} ms; bound "
              f"{t['bounds']['bound_ms'] * 1e3:.3f} us ({t['bounds']['bytes']:,} B, "
              f"{100 * t['bounds']['bound_ms'] / t['device_ms']:.2f} % at device time)")
    return out


def serpentine_firings():
    """Two revolutions of one two-cell-thick zigzag ribbon at 6 m spanning
    the whole rotation (the adversarial CC input of tests/test_cc_pallas.py)."""
    from continuous_clustering_tpu_torch.evaluation.synthetic import frame_to_firings

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
