"""The column-sharded steps on the card.

Marked ``cuda``: skips without a CUDA device.  Imports nothing of JAX or of
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_halo_card.py

A 32 x 220 stream (ring of 4 revolutions, firing batch 64, 5 revolutions
so the ring wraps) captured with the host insertion on the card runs
through the unsharded ``pipeline_step_block`` and through the halo step
with 4 column shards on the card, slab on.  Two such streams as firing
batches run through the device-insertion multi-sensor step on a dp 2 x
sp 4 mesh on the card and through the unsharded one.  Tolerance: exact,
every state field and every step's meta, slab and tail; K1 and K2 launch
once a step.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def test_halo_step_on_the_card_equals_the_unsharded_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings,
                                                                      make_scene, raycast_frame)
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
    from continuous_clustering_tpu_torch.models.step import pipeline_step_block
    from continuous_clustering_tpu_torch.ops import cc_cuda
    from continuous_clustering_tpu_torch.ops.state import init_state
    from continuous_clustering_tpu_torch.parallel.halo import make_halo_sharded_step
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree

    dev = torch.device("cuda", 0)
    cfg = kitti_config()
    cfg = cfg.replace(range_image=dataclasses.replace(cfg.range_image, num_columns=220,
                                                      ring_buffer_revolutions=4))
    pipe = ContinuousClustering(cfg, firing_batch_size=64, device=dev)
    pipe.reset(32)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    scene = make_scene(num_boxes=6, seed=2, spread=18.0)
    ins, steps = pipe._host_ins, []
    for rev in range(5):
        xyz, _ = raycast_frame(scene, num_rows=32, num_columns=220, seed=2 + rev)
        firings = frame_to_firings(xyz, frame_index=rev)
        first, end, reset = ins.add_firings(firings, [np.eye(4)] * len(firings))
        while first < end:
            staged, n = pipe._stage_block(first, end, reset)
            steps.append(pipe._upload_block(staged))
            first += n
        ins.clear_before(end - 220)
    B, hsg = pipe._batch_B, torch.tensor(np.float32(-1.7), device=dev)
    mesh = make_mesh(devices=[dev] * 4, dp=1)
    run = make_halo_sharded_step(cfg, mesh, B, slab_cols=128, slab_head=64)
    sh, ref = shard_pytree(mesh, init_state(cfg, 32, dev), stacked=False), init_state(cfg, 32, dev)
    for k, (blk, segp) in enumerate(steps):
        ref, rinfo = pipeline_step_block(cfg, ref, blk, segp, hsg, B, 128, 64)
        cc_cuda.reset_launch_counts()
        sh, info = run(sh, blk, segp, hsg)
        assert cc_cuda.LAUNCHES == {"edge_bits": 1, "window_cc": 1, "ground_segment": 1}, k
        for a, b in zip(info, rinfo):
            assert torch.equal(a, b), f"step {k}"
    whole = gather_state(sh)
    assert whole.x.device == dev and int(ref.ring_start) > 0
    assert_states_equal(whole, ref)


def assert_states_equal(a, b) -> None:
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype.is_floating_point:
            assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())
        else:
            assert torch.equal(x, y), f.name


def test_sharded_insertion_on_the_card_equals_the_unsharded_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings,
                                                                      make_scene, raycast_frame)
    from continuous_clustering_tpu_torch.models.step import EgoCalibration
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops import cc_cuda
    from continuous_clustering_tpu_torch.ops.insertion import make_firing_batch
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree
    from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                       stacked_init)

    dev = torch.device("cuda", 0)
    cfg = kitti_config()
    cfg = cfg.replace(range_image=dataclasses.replace(cfg.range_image, num_columns=220,
                                                      ring_buffer_revolutions=4))
    F, B, eye = 64, 96, np.eye(4)
    streams = []
    for seed in (2, 3):
        scene = make_scene(num_boxes=6, seed=seed, spread=18.0)
        streams.append(sum((frame_to_firings(raycast_frame(scene, num_rows=32, num_columns=220,
                                                           seed=seed + rev)[0], frame_index=rev)
                            for rev in range(5)), []))
    batches = [stack_batches([make_firing_batch(f[k:k + F], [eye] * len(f[k:k + F]), F, 32, dev)
                              for f in streams]) for k in range(0, len(streams[0]), F)]
    calib = EgoCalibration(torch.stack([torch.eye(4, device=dev)[:3]] * 2),
                           torch.full((2,), -1.7, device=dev))
    mesh = make_mesh(devices=[dev] * 8)
    run = make_sharded_step(cfg, B, slab_cols=128, slab_head=64, mesh=mesh)
    one_run = make_sharded_step(cfg, B, slab_cols=128, slab_head=64, device=dev)
    sh = shard_pytree(mesh, stacked_init(cfg, 32, 2, dev), stacked=True)
    one = stacked_init(cfg, 32, 2, dev)
    for k, batch in enumerate(batches):
        one, oinfo = one_run(one, batch, calib)
        cc_cuda.reset_launch_counts()
        sh, info = run(sh, batch, calib)
        # ground segmentation once per stream
        assert cc_cuda.LAUNCHES == {"edge_bits": 1, "window_cc": 1, "ground_segment": 2}, k
        for a, b in zip(info, oinfo):
            assert torch.equal(a, b), f"step {k}"
    assert int(one.ring_start.min()) > 0 and int(oinfo.gcol0.min()) + B > 880
    assert all(part.x.shape[-1] == 220 for row in sh.shards for part in row)
    assert_states_equal(gather_state(sh), one)
