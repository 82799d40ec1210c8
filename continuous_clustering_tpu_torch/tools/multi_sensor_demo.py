"""Multi-sensor streaming demo (port of
``continuous_clustering_tpu/tools/multi_sensor_demo.py``; the reference's
demo_touareg.launch analog).

Runs N independent sensor streams, the reference's three-node deployment
(roof VLS-128 + two tilted OS-32, launch/demo_touareg.launch:20-31), either
as one ``ContinuousClustering`` facade per sensor (host-parallel) or through
the multi-sensor step (``--sharded``: ``parallel/multi_sensor.py`` on a
``parallel/mesh.py`` mesh whose dp rows split the sensors and whose sp
columns split each ring over the cards left over, K1 and K2 launched once
per step and device for all its sensors), on ``--device`` (every visible
card unless ``--device cpu`` or a numbered card).

Usage:
    python -m continuous_clustering_tpu_torch.tools.multi_sensor_demo \\
        [--sensors 3] [--rows 32] [--columns 440] [--revolutions 2] [--sharded] \\
        [--device cuda]

Prints one JSON line with the JAX tool's keys, and the device it ran on.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..evaluation.synthetic import frame_to_firings, make_scene, raycast_frame
from ..models.continuous_clustering import ContinuousClustering
from ..utils.cli import CommandLineParser

F_BATCH = 110  # firings per step


def tilted_pose(roll_deg: float) -> np.ndarray:
    """Sensor mounted with a roll tilt (the touareg OS-32s are tilted)."""
    r = math.radians(roll_deg)
    m = np.eye(4)
    m[:3, :3] = np.array(
        [[1, 0, 0], [0, math.cos(r), -math.sin(r)], [0, math.sin(r), math.cos(r)]])
    return m


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    p = CommandLineParser(argv if argv is not None else sys.argv[1:])
    n_sensors = int(p.get_value_for_argument("--sensors", "3"))
    rows = int(p.get_value_for_argument("--rows", "32"))
    cols = int(p.get_value_for_argument("--columns", "440"))
    revolutions = int(p.get_value_for_argument("--revolutions", "2"))
    sharded = p.argument_exists("--sharded")
    dev = torch.device(p.get_value_for_argument("--device", "cuda"))

    base = Config()
    cfg = base.replace(
        range_image=base.range_image.__class__(num_columns=cols, ring_buffer_revolutions=4))

    scenes = [make_scene(num_boxes=6 + i, seed=i, spread=22.0) for i in range(n_sensors)]
    frames = [raycast_frame(s, num_rows=rows, num_columns=cols, seed=i)[0]
              for i, s in enumerate(scenes)]
    tilts = [tilted_pose(0.0 if i == 0 else (20.0 if i % 2 else -20.0)) for i in range(n_sensors)]

    if sharded:
        result = _run_sharded(cfg, rows, cols, revolutions, frames, dev)
    else:
        result = _run_host_parallel(cfg, rows, revolutions, frames, tilts, dev)
    result["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(json.dumps(result))
    return result


def _run_host_parallel(cfg, rows, revolutions, frames, tilts, dev) -> dict:
    n_sensors = len(frames)
    pipes = []
    counts = [0] * n_sensors
    for i in range(n_sensors):
        pipe = ContinuousClustering(cfg, firing_batch_size=F_BATCH, device=dev)
        pipe.reset(rows)
        pipe.set_transform_robot_frame_from_sensor_frame(tilts[i])
        pipe.set_finished_cluster_callback(
            lambda pts, stamp, i=i: counts.__setitem__(i, counts[i] + 1))
        pipes.append(pipe)

    total_points = 0
    t0 = time.perf_counter()
    for rev in range(revolutions):
        for i, pipe in enumerate(pipes):
            for firing in frame_to_firings(frames[i], start_stamp=rev * 10**8,
                                           end_stamp=(rev + 1) * 10**8, frame_index=rev):
                pipe.add_firing(firing, np.eye(4))
                total_points += int(np.sum(~np.isnan(firing["xyz"][:, 0])))
    for pipe in pipes:
        pipe.flush()
    _synchronize(dev)
    dt = time.perf_counter() - t0
    return {"sensors": n_sensors, "clusters_per_sensor": counts,
            "points_per_second": round(total_points / dt, 1), "mode": "host-parallel"}


def _run_sharded(cfg, rows, cols, revolutions, frames, dev) -> dict:
    from ..models.step import EgoCalibration
    from ..ops.insertion import FiringBatch
    from ..parallel.mesh import shard_pytree
    from ..parallel.multi_sensor import make_sharded_step, stacked_init

    S = len(frames)
    mesh = _demo_mesh(S, dev)
    state = shard_pytree(mesh, stacked_init(cfg, rows, S, mesh.devices[0][0]), stacked=True)
    run = make_sharded_step(cfg, batch_cols=F_BATCH + 32, mesh=mesh)

    def batch_for(frame, rev, lo, hi):
        firings = frame_to_firings(frame, frame_index=rev)[lo:hi]
        xyz = np.full((F_BATCH, rows, 3), np.nan, np.float32)
        for k, f in enumerate(firings):
            xyz[k] = f["xyz"]
        z = torch.zeros((F_BATCH, rows), dtype=torch.int32)
        return FiringBatch(
            xyz=torch.from_numpy(xyz),
            pose=torch.from_numpy(np.stack([np.eye(4)[:3]] * F_BATCH).astype(np.float32)),
            stamp_lo=z, stamp_hi=z, uidx_lo=z, uidx_hi=z, intensity=z,
            firing_index=torch.arange(F_BATCH, dtype=torch.int32) + lo,
            valid=torch.from_numpy(np.arange(F_BATCH) < len(firings)))

    calib = EgoCalibration(
        ego_from_sensor=torch.from_numpy(np.stack([np.eye(4)[:3]] * S).astype(np.float32)),
        height_sensor_to_ground=torch.full((S,), -1.7, dtype=torch.float32))

    for d in mesh.distinct_devices():
        _synchronize(d)
    t0 = time.perf_counter()
    n_chunks = (cols + F_BATCH - 1) // F_BATCH
    clusters = 0
    for rev in range(revolutions):
        for c in range(n_chunks):
            batches = [batch_for(frames[i], rev, c * F_BATCH, (c + 1) * F_BATCH)
                       for i in range(S)]
            sbatch = FiringBatch(*[torch.stack(xs) for xs in zip(*batches)])
            state, info = run(state, sbatch, calib)
            clusters += int(info.num_new_clusters.sum())
    for d in mesh.distinct_devices():
        _synchronize(d)
    dt = time.perf_counter() - t0
    return {"sensors": S, "mesh": mesh.shape, "total_new_clusters": clusters,
            "wall_s": round(dt, 2), "mode": "sharded"}


def _demo_mesh(n_sensors: int, dev: torch.device):
    """The mesh of the sharded demo, as the JAX demo's ``make_mesh(dp=min(S,
    n))`` makes it: the sensors split evenly over dp, as many rows as divide
    their number and fit the devices, and the devices left over after dp
    split each ring's columns over sp = n // dp.  ``cuda`` means every
    visible card; a numbered card or the CPU holds all sensors (dp 1, sp
    1)."""
    from ..parallel.mesh import make_mesh

    devices = ([dev] if dev.type != "cuda" or dev.index is not None
               else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    dp = max(d for d in range(1, len(devices) + 1) if n_sensors % d == 0)
    sp = len(devices) // dp
    return make_mesh(n_devices=dp * sp, dp=dp, devices=devices)


if __name__ == "__main__":
    main()
