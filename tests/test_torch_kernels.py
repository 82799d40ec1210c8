"""The CUDA kernels against their plain twins on the card.

Marked ``cuda``: each test skips without a CUDA device.  Imports nothing of
JAX or of the JAX package, so the file runs on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX).  The windows are
real association windows of two synthetic streams at 32 x 220, 64 x 2200
and 128 x 1700 (``tools/cc_windows.py``: a KITTI-like scene and the
throughput runs' ``near_field`` scene), and the synthetic windows of
``tools/cc_windows.py``: dense random edge words,
one at R = 128, B = 512, and a snake that runs into the round cap.  The
ground segmentation kernel runs on ray-cast steps of ``ground_cases.py``
and host-inserted steps against its twin, every state field bit for bit.  The
stacked launches (several windows in one launch, as the multi-sensor step
makes them) must equal each window's own launch and twin, the round counts
of windows that converge after different numbers of rounds included.  The
probe variants run on their own inputs at upper 1, 7 and 21, and those that
read no bits at upper 300, past the padded width.  Tolerance: bits,
labels, the converged flag, the round count, the probe outputs and the
segmented state exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from continuous_clustering_tpu_torch.config import kitti_config
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)
from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


# (preset, rows, columns, firing batch)
WINDOW_SIZES = {
    "32x220": ("kitti", 32, 220, 48),
    "64x2200": ("kitti", 64, 2200, 384),
    "vls128-128x1700": ("vls128_roof", 128, 1700, 256),
}


@pytest.fixture(scope="module", params=list(WINDOW_SIZES))
def size(request):
    _card()
    from continuous_clustering_tpu_torch.config import PRESETS

    preset, rows, cols, batch = WINDOW_SIZES[request.param]
    cfg = PRESETS[preset]()
    if cols == 220:
        cfg = cfg.replace(range_image=dataclasses.replace(
            cfg.range_image, num_columns=cols, ring_buffer_revolutions=4))
    assert cfg.range_image.num_columns == cols
    return cfg, rows, batch


@pytest.fixture(scope="module")
def window(size):
    from continuous_clustering_tpu_torch.tools.cc_windows import stream_firings, stream_window

    cfg, rows, batch = size
    cols = cfg.range_image.num_columns
    if cols == 220:
        firings, stops = stream_firings(rows, cols, 1, seed=3, num_boxes=12, spread=15.0), [180]
    else:
        firings, stops = stream_firings(rows, cols, 2), [3 * cols // 2]
    return cfg, stream_window(cfg, rows, batch, firings, stops)


@pytest.fixture(scope="module")
def near_field_window(size):
    from continuous_clustering_tpu_torch.tools.cc_windows import near_field_window

    cfg, rows, batch = size
    return cfg, near_field_window(cfg, rows, batch)


def _edge_bits_check(cfg, win):
    from continuous_clustering_tpu_torch.ops import cc_cuda

    cl = cfg.clustering
    md = np.float32(cl.max_distance)
    args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
    kw = dict(H=cl.max_steps_in_row, V=cl.max_steps_in_column, max_d2=float(md * md))
    before = LAUNCHES["edge_bits"]
    bits = cc_cuda.edge_bits(*args, **kw)
    assert LAUNCHES["edge_bits"] == before + 1
    ref = cc_cuda.edge_bits_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int((ref != 0).sum()) > 0
    assert torch.equal(bits, ref)
    return bits


def _window_cc_check(bits, L0, max_wp, H, V, converged=True):
    from continuous_clustering_tpu_torch.ops import cc_cuda

    before = LAUNCHES["window_cc"]
    L, ok, rounds = cc_cuda.window_cc(bits, L0, max_wp, H=H, V=V)
    assert LAUNCHES["window_cc"] == before + 1
    L_ref, ok_ref, rounds_ref = cc_cuda.window_cc_reference(bits, L0, max_wp, H=H, V=V)
    torch.cuda.synchronize()
    assert torch.equal(L, L_ref)
    assert bool(ok) == bool(ok_ref) == converged
    assert int(rounds) == int(rounds_ref) >= 1


def test_edge_bits_kernel_matches_plain(window):
    _edge_bits_check(*window)


def test_edge_bits_kernel_matches_plain_near_field(near_field_window):
    _edge_bits_check(*near_field_window)


def test_window_cc_kernel_matches_plain(window):
    cfg, win = window
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    bits = _edge_bits_check(cfg, win)
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    _window_cc_check(bits, win.L0, max_wp, H, V)


def test_window_cc_kernel_matches_plain_near_field(near_field_window):
    cfg, win = near_field_window
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    bits = _edge_bits_check(cfg, win)
    max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
    _window_cc_check(bits, win.L0, max_wp, H, V)


@pytest.mark.parametrize("case", ["random-0", "random-1", "dense-2", "wide-3", "snake"])
def test_window_cc_kernel_matches_plain_on_synthetic_windows(case):
    """Rounds equal too: the kernel runs the twin's Jacobi rounds.  ``wide``
    is R = 128, B = 512, beyond one block's shared memory (the first K2
    kept its labels there); ``snake`` stops at the round cap unconverged."""
    _card()
    from continuous_clustering_tpu_torch.tools import cc_windows

    H = V = 20
    if case == "snake":
        bits, L0, max_wp = cc_windows.snake_window(64, 416, H, V)
    else:
        kind, seed = case.split("-")
        R, B = (128, 512) if kind == "wide" else (64, 416)
        bits, L0, max_wp = cc_windows.random_window(
            R, B, H, V, density=0.01 if kind == "dense" else 0.002, seed=int(seed))
    _window_cc_check(bits.cuda(), L0.cuda(), max_wp.cuda(), H, V, converged=case != "snake")


def test_stacked_edge_bits_match_each_window(window, near_field_window):
    """One K1 launch over the KITTI-like and the near-field window."""
    from continuous_clustering_tpu_torch.ops import cc_cuda

    cfg, win = window
    cl = cfg.clustering
    md = np.float32(cl.max_distance)
    kw = dict(H=cl.max_steps_in_row, V=cl.max_steps_in_column, max_d2=float(md * md))
    wins = (win, near_field_window[1])
    fields = ("xw", "yw", "zw", "incw", "active_w", "mad", "wp")
    before = LAUNCHES["edge_bits"]
    bits = cc_cuda.edge_bits_stacked(*(torch.stack([getattr(w, f) for w in wins])
                                       for f in fields), **kw)
    assert LAUNCHES["edge_bits"] == before + 1
    for s, w in enumerate(wins):
        assert torch.equal(bits[s], _edge_bits_check(cfg, w))


def test_stacked_window_cc_matches_each_window():
    """One K2 launch over windows that stop after different numbers of
    rounds (the snake unconverged at the cap): each window's labels,
    converged flag and round count are its own launch's and its twin's."""
    _card()
    from continuous_clustering_tpu_torch.ops import cc_cuda
    from continuous_clustering_tpu_torch.tools import cc_windows

    H = V = 20
    wins = [cc_windows.random_window(64, 416, H, V, seed=0),
            cc_windows.snake_window(64, 416, H, V),
            cc_windows.random_window(64, 416, H, V, density=0.01, seed=2)]
    bits, L0, max_wp = (torch.cat([w[i][None] if i < 2 else w[i] for w in wins]).cuda()
                        for i in range(3))
    before = LAUNCHES["window_cc"]
    L, ok, rounds = cc_cuda.window_cc_stacked(bits, L0, max_wp, H=H, V=V)
    assert LAUNCHES["window_cc"] == before + 1
    torch.cuda.synchronize()
    assert ok.tolist() == [True, False, True] and rounds[1] == cc_cuda.MAX_ROUNDS
    assert len(set(rounds.tolist())) == 3
    for s in range(len(wins)):
        L1, ok1, r1 = cc_cuda.window_cc(bits[s], L0[s], max_wp[s:s + 1], H=H, V=V)
        L_ref, ok_ref, r_ref = cc_cuda.window_cc_reference(bits[s], L0[s], max_wp[s:s + 1],
                                                           H=H, V=V)
        assert torch.equal(L[s], L1) and torch.equal(L[s], L_ref)
        assert bool(ok[s]) == bool(ok1) == bool(ok_ref)
        assert int(rounds[s]) == int(r1) == int(r_ref)


@pytest.mark.parametrize("upper", [1, 7, 21])
def test_sweep_probe_kernels_match_plain(upper):
    _card()
    from continuous_clustering_tpu_torch.ops import sweep_probe
    from continuous_clustering_tpu_torch.tools.sweep_probe import run

    before = LAUNCHES["sweep_probe"]
    results = run("cuda", seed=upper, uppers=(upper,))
    assert results == [(name, "OK", 0) for name in sweep_probe.VARIANTS]
    assert LAUNCHES["sweep_probe"] == before + len(sweep_probe.VARIANTS)


@pytest.mark.parametrize("name", ["V2_dynamic_roll", "V5_cmp_astype_prefix", "V6_bitpack"])
def test_sweep_probe_shift_wraps_past_the_padded_width(name):
    """At upper = 300 the roll's shift passes the padded width PW = 256: the
    kernel carries it modulo PW by one compare (the variants that read no
    bits; the others stop at H + 1)."""
    _card()
    from continuous_clustering_tpu_torch.ops.sweep_probe import sweep_probe, sweep_probe_reference
    from continuous_clustering_tpu_torch.tools.sweep_probe import probe_inputs

    bits, L = (torch.from_numpy(a).cuda() for a in probe_inputs(3))
    upper = torch.tensor(300, dtype=torch.int32, device="cuda")
    got = sweep_probe(name, bits, upper, L)
    assert torch.equal(got, sweep_probe_reference(name, bits, upper, L))


# ground segmentation: (preset, switches, rows, B, n_cols, stale cells); every
# window wraps the ring's end and holds NaN cells and columns, every carry NaN
# entries.  The main path's shapes (KITTI 64 x 416, the VLS-128 node 128 x
# 288, OS-32 with its fog filtering 32 x 160), the other switches, n_cols of
# 0 and 1, overflow, and B past one tile of 512 threads.
GROUND_CASES = {
    "kitti-64x416": ("kitti", "preset", 64, 416, 416, False),
    "vls128-128x288": ("vls128_roof", "preset", 128, 288, 250, False),
    "os32-fog-32x160": ("os32", "preset", 32, 160, 160, False),
    "terrain-64x416": ("kitti", "terrain", 64, 416, 300, False),
    "n0": ("kitti", "preset", 64, 416, 0, False),
    "n1": ("kitti", "preset", 64, 416, 1, False),
    "overflow": ("kitti", "preset", 64, 416, 200, True),
    "tiles-16x1500": ("kitti", "fog", 16, 1500, 1400, False),
}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# host-inserted steps of a KITTI-like stream at the main path's shapes
# (``tools/cc_windows.segment_step``): (preset, rows, firing batch), B =
# batch + 32
STREAM_CASES = {
    "kitti-stream-64x416": ("kitti", 64, 384),
    "vls128-stream-128x288": ("vls128_roof", 128, 256),
}


@pytest.mark.parametrize("case", list(GROUND_CASES) + list(STREAM_CASES))
def test_ground_segment_kernel_matches_plain(case):
    """The kernel against the twin on the card, every state field bit for
    bit (the ring fields it writes, ``incl_diffs`` and ``overflow`` among
    them); the poses are views of one packed (B, 15) buffer, as the facade
    uploads them."""
    _card()
    from continuous_clustering_tpu_torch.config import PRESETS
    from continuous_clustering_tpu_torch.ops.ground_segmentation import (
        SegmentInputs, ground_segment_columns, ground_segment_columns_reference)
    from continuous_clustering_tpu_torch.ops.state import copy_state, init_state

    from .ground_cases import segment_case, with_switches

    if case in STREAM_CASES:
        from continuous_clustering_tpu_torch.tools.cc_windows import segment_step

        preset, rows, batch = STREAM_CASES[case]
        cfg = PRESETS[preset]()
        reset_launch_counts()
        streamed, tin, B, steps = segment_step(cfg, rows, batch)
        assert steps >= 2 and LAUNCHES["ground_segment"] == steps
        n_cols, stale = None, False

        def state():
            return copy_state(streamed)
    else:
        preset, switches, R, B, n_cols, stale = GROUND_CASES[case]
        cfg = with_switches(PRESETS[preset](), switches)
        cells, extra, inp = segment_case(cfg, R, B, n_cols, seed=R + B + n_cols, overflow=stale)

        def state():
            st = init_state(cfg, R, "cuda")
            for name, a in cells.items():
                getattr(st, name).copy_(torch.from_numpy(a))
            st.incl_diffs = torch.from_numpy(extra["incl_diffs"]).cuda()
            st.origin_rot = torch.tensor(extra["origin_rot"], device="cuda")
            return st

        packed = torch.from_numpy(np.concatenate(
            [inp["sensor_pos"], inp["ego_rot"].reshape(B, 9), inp["ego_trans"]], 1)).cuda()
        tin = SegmentInputs(
            gcol0=torch.tensor(inp["gcol0"], device="cuda"),
            n_cols=torch.tensor(inp["n_cols"], device="cuda"),
            sensor_pos=packed[:, 0:3], ego_rot=packed[:, 3:12].reshape(B, 3, 3),
            ego_trans=packed[:, 12:15],
            height_sensor_to_ground=torch.tensor(inp["height_sensor_to_ground"], device="cuda"))
    before = LAUNCHES["ground_segment"]
    got = ground_segment_columns(cfg, state(), tin, B)
    assert LAUNCHES["ground_segment"] == before + 1
    want = ground_segment_columns_reference(cfg, state(), tin, B)
    torch.cuda.synchronize()
    assert LAUNCHES["ground_segment"] == before + 1
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.device == b.device and torch.equal(_bits(a), _bits(b)), f"{case}: {f.name}"
    assert bool(got.overflow) == stale
    if n_cols == 0:
        assert torch.equal(_bits(got.incl_diffs), _bits(torch.from_numpy(extra["incl_diffs"]).cuda()))


def test_ground_segment_launches_once_a_step_on_the_card():
    """A host-insertion stream through the facade on the card launches the
    kernel once a step: the registry's launch count equals its steps."""
    _card()
    from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
    from continuous_clustering_tpu_torch.utils.stats import TRACE

    cfg = kitti_config()
    cfg = cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=220, ring_buffer_revolutions=4))
    pipe = ContinuousClustering(cfg, firing_batch_size=48, device="cuda")
    pipe.reset(32)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    scene = make_scene(num_boxes=12, seed=3, spread=15.0)
    xyz, _ = raycast_frame(scene, num_rows=32, num_columns=220, seed=3)
    reset_launch_counts()
    TRACE.clear()
    for f in frame_to_firings(xyz):
        pipe.add_firing(f, np.eye(4))
    pipe.flush()
    snap = TRACE.snapshot()
    assert snap["steps"] == pipe.n_steps > 3
    assert snap["launches"]["ground_segment"] == pipe.n_steps
