"""The CUDA kernels against their plain twins on the card.

Marked ``cuda``: each test skips without a CUDA device.  Imports nothing of
JAX or of the JAX package, so the file runs on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX).  The window is a
real association window of the synthetic stream at 32 x 220, batch 48.
Tolerance: bits, labels and the converged flag exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from continuous_clustering_tpu_torch.config import kitti_config
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def window():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
    from continuous_clustering_tpu_torch.ops.association import window_arrays

    cfg = kitti_config()
    cfg = cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=220, ring_buffer_revolutions=4))
    scene = make_scene(num_boxes=12, seed=3, spread=15.0)
    xyz, _ = raycast_frame(scene, num_rows=32, num_columns=220, seed=3)
    pipe = ContinuousClustering(cfg, firing_batch_size=48, device="cuda")
    pipe.reset(32)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    for f in frame_to_firings(xyz)[:180]:
        pipe.add_firing(f, np.eye(4))
    B = 48 + 32
    win = window_arrays(cfg, pipe.state, pipe.state.first_unfinished - B,
                        torch.tensor(B, dtype=torch.int32, device="cuda"), B)
    return cfg, win


def test_edge_bits_kernel_matches_plain(window):
    from continuous_clustering_tpu_torch.ops import cc_cuda

    cfg, win = window
    cl = cfg.clustering
    md = np.float32(cl.max_distance)
    args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
    kw = dict(H=cl.max_steps_in_row, V=cl.max_steps_in_column, max_d2=float(md * md))
    before = cc_cuda.LAUNCHES["edge_bits"]
    bits = cc_cuda.edge_bits(*args, **kw)
    assert cc_cuda.LAUNCHES["edge_bits"] == before + 1
    ref = cc_cuda.edge_bits_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int((ref != 0).sum()) > 0
    assert torch.equal(bits, ref)


def test_window_cc_kernel_matches_plain(window):
    from continuous_clustering_tpu_torch.ops import cc_cuda

    cfg, win = window
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    md = np.float32(cfg.clustering.max_distance)
    bits = cc_cuda.edge_bits_reference(win.xw, win.yw, win.zw, win.incw, win.active_w,
                                       win.mad, win.wp, H=H, V=V, max_d2=float(md * md))
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    before = cc_cuda.LAUNCHES["window_cc"]
    L, ok, rounds = cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V)
    assert cc_cuda.LAUNCHES["window_cc"] == before + 1
    L_ref, ok_ref, _ = cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V)
    torch.cuda.synchronize()
    assert torch.equal(L, L_ref)
    assert bool(ok) and bool(ok_ref) and int(rounds) >= 1


def test_window_cc_refuses_a_window_beyond_shared_memory(window):
    from continuous_clustering_tpu_torch.ops import cc_cuda

    # 128 x (20 + 512) labels = 272,384 bytes > 232,448 (128 x 436 still fits)
    R, H, B = 128, 20, 512
    bits = torch.zeros((H + 1, 2, R, B), dtype=torch.int32, device="cuda")
    L0 = torch.zeros((R, H + B), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="shared"):
        cc_cuda.window_cc(bits, L0, torch.zeros(1, dtype=torch.int32, device="cuda"), H=H, V=20)
