"""The column-sharded steps on the card.

Marked ``cuda``: skips without a CUDA device.  Imports nothing of JAX or of
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_halo_card.py

Two sizes (``SIZES``): 32 x 220 (ring of 4 revolutions, firing batch 64, 5
revolutions, so the ring wraps) and the KITTI configuration (64 x 2200,
ring of 10 revolutions, firing batch 384, 2,750-5,500 columns a shard).
Streams captured with the host insertion on the card run through the
unsharded ``pipeline_step_block`` and through the halo step with every
shard on the card: 4 column shards with the slab, 8 column shards, and two
streams stacked over dp 2 x sp 4.  Two streams as firing batches run
through the device-insertion multi-sensor step on a dp 2 x sp 4 and a dp 1
x sp 8 mesh on the card and through the unsharded one.  Tolerance: exact,
every state field and every step's meta, slab and tail; K1 and K2 launch
once a step, ground segmentation once a stream.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# (column shards, dp, streams, slab (W, head))
HALO_LAYOUTS = {
    "nsp4-slab": (4, 1, 1, (128, 64)),
    "nsp8": (8, 1, 1, (0, 0)),
    "dp2xsp4-stacked": (8, 2, 2, (0, 0)),
}
# rows, columns, revolutions, firing batch, and the scene's boxes and spread
SIZES = {"32x220": (32, 220, 5, 64, 6, 18.0), "64x2200": (64, 2200, 3, 384, 14, 30.0)}


def _config(size):
    from continuous_clustering_tpu_torch.config import kitti_config

    cfg = kitti_config()
    if size == "64x2200":
        return cfg
    return cfg.replace(range_image=dataclasses.replace(cfg.range_image, num_columns=220,
                                                       ring_buffer_revolutions=4))


def _streams(size, n, n_rev=None):
    """``n`` streams of firings, each its own scene."""
    from continuous_clustering_tpu_torch.tools.cc_windows import stream_firings

    rows, cols, revs, _, boxes, spread = SIZES[size]
    return [stream_firings(rows, cols, n_rev or revs, seed=2 + s, num_boxes=boxes + s,
                           spread=spread) for s in range(n)]


def _capture(size, cfg, dev, firings):
    """(block, seg_poses) of every step of ``firings``, host-inserted on the
    card a revolution at a time, and the step width B."""
    from continuous_clustering_tpu_torch.tools.bench_setup import _insert_revolution
    from continuous_clustering_tpu_torch.tools.cc_windows import _facade

    rows, cols, _, batch, _, _ = SIZES[size]
    pipe, steps = _facade(cfg, rows, batch, dev), []
    for k in range(0, len(firings), cols):
        steps += zip(*_insert_revolution(pipe, firings[k:k + cols], cols))
    return steps, pipe._batch_B


@pytest.mark.parametrize("layout,size", [(lay, "32x220") for lay in HALO_LAYOUTS]
                         + [("nsp4-slab", "64x2200"), ("dp2xsp4-stacked", "64x2200")])
def test_halo_step_on_the_card_equals_the_unsharded_step(layout, size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    from continuous_clustering_tpu_torch.models.step import pipeline_step_block
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.state import init_state
    from continuous_clustering_tpu_torch.parallel.halo import make_halo_sharded_step
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree
    from continuous_clustering_tpu_torch.parallel.multi_sensor import stacked_init
    from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

    nsp, dp, S, slab = HALO_LAYOUTS[layout]
    rows = SIZES[size][0]
    dev = torch.device("cuda", 0)
    cfg = _config(size)
    captured = [_capture(size, cfg, dev, f) for f in _streams(size, S)]
    B, hsg = captured[0][1], torch.tensor(np.float32(-1.7), device=dev)
    n = min(len(steps) for steps, _ in captured)
    refs = []
    for steps, _ in captured:
        ref, infos = init_state(cfg, rows, dev), []
        for blk, segp in steps[:n]:
            ref, info = pipeline_step_block(cfg, ref, blk, segp, hsg, B, *slab)
            infos.append(info)
        assert int(ref.ring_start) > 0
        refs.append((ref, infos))
    mesh = make_mesh(devices=[dev] * nsp, dp=dp)
    run = make_halo_sharded_step(cfg, mesh, B, stacked=S > 1, slab_cols=slab[0],
                                 slab_head=slab[1])
    if S > 1:
        sh = shard_pytree(mesh, stacked_init(cfg, rows, S, dev), stacked=True)
        steps = [tuple(stack_batches([st[k][i] for st, _ in captured]) for i in range(2))
                 for k in range(n)]
        h = torch.stack([hsg] * S)
    else:
        sh = shard_pytree(mesh, init_state(cfg, rows, dev), stacked=False)
        steps, h = captured[0][0][:n], hsg
    for k, (blk, segp) in enumerate(steps):
        reset_launch_counts()
        sh, info = run(sh, blk, segp, h)
        assert LAUNCHES == {"edge_bits": 1, "window_cc": 1, "ground_segment": S,
                            "sweep_probe": 0}, k
        for s, (_, infos) in enumerate(refs):
            got = [t[s] for t in info] if S > 1 else info
            for a, b in zip(got, infos[k]):
                assert torch.equal(a, b), f"stream {s}, step {k}"
    whole = gather_state(sh)
    assert whole.x.device == dev
    for s, (ref, _) in enumerate(refs):
        assert_states_equal(type(ref)(**{f: t[s] for f, t in vars(whole).items()})
                            if S > 1 else whole, ref)


def assert_states_equal(a, b) -> None:
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype.is_floating_point:
            assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())
        else:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("dp,nsp,size", [(2, 4, "32x220"), (1, 8, "32x220"),
                                         (2, 4, "64x2200")])
def test_sharded_insertion_on_the_card_equals_the_unsharded_step(dp, nsp, size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from continuous_clustering_tpu_torch.models.step import EgoCalibration
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.insertion import make_firing_batch
    from continuous_clustering_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_pytree
    from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                       stacked_init)
    from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

    dev = torch.device("cuda", 0)
    cfg = _config(size)
    rows, F, rc, eye = SIZES[size][0], SIZES[size][3], cfg.ring_buffer_max_columns, np.eye(4)
    # the KITTI configuration over its first revolution
    streams, B = _streams(size, 2, n_rev=1 if size == "64x2200" else None), F + 32
    batches = [stack_batches([make_firing_batch(f[k:k + F], [eye] * len(f[k:k + F]), F, rows, dev)
                              for f in streams]) for k in range(0, len(streams[0]), F)]
    calib = EgoCalibration(torch.stack([torch.eye(4, device=dev)[:3]] * 2),
                           torch.full((2,), -1.7, device=dev))
    mesh = make_mesh(devices=[dev] * (dp * nsp), dp=dp)
    assert mesh.shape == {"dp": dp, "sp": nsp}
    run = make_sharded_step(cfg, B, slab_cols=128, slab_head=64, mesh=mesh)
    one_run = make_sharded_step(cfg, B, slab_cols=128, slab_head=64, device=dev)
    sh = shard_pytree(mesh, stacked_init(cfg, rows, 2, dev), stacked=True)
    one, new_clusters = stacked_init(cfg, rows, 2, dev), 0
    for k, batch in enumerate(batches):
        one, oinfo = one_run(one, batch, calib)
        reset_launch_counts()
        sh, info = run(sh, batch, calib)
        # ground segmentation once per stream
        assert LAUNCHES == {"edge_bits": 1, "window_cc": 1, "ground_segment": 2,
                            "sweep_probe": 0}, k
        for a, b in zip(info, oinfo):
            assert torch.equal(a, b), f"step {k}"
        new_clusters = new_clusters + oinfo.num_new_clusters
    assert int(new_clusters.min()) > 0
    if size == "32x220":   # the ring wrapped
        assert int(one.ring_start.min()) > 0 and int(oinfo.gcol0.min()) + B > rc
    assert all(part.x.shape[-1] == rc // nsp for row in sh.shards for part in row)
    assert_states_equal(gather_state(sh), one)
