"""``record_neighbor_stats`` in the port against the JAX package, on the CPU.

With the flag on, the port computes the visited-neighbour counter in plain
PyTorch from the association window (``ops/association.py::
neighbor_stats``) and still takes K1's bits for the edges found; the JAX
package computes it in its XLA branch.  The counter is exact for
``stop_after_association_enabled=False`` (the setting of
``tests/test_pipeline.py::test_visited_neighbor_counts_match_oracle``).

Rule: the ``nbr_stats`` ring field, every other state field (by the rule of
``tests/test_torch_step.py``), the meta vector and the publish slab with its
trailing ``nbr_stats`` row equal the JAX step's after every step; the
facade's ``number_of_visited_neighbors`` and ``num_child_points`` equal the
JAX facade's for every published point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.models.continuous_clustering import (
    ContinuousClustering as JaxContinuousClustering)
from continuous_clustering_tpu.models.step import pipeline_step_block as jax_step
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.models.step import pipeline_step_block
from continuous_clustering_tpu_torch.ops.readout import N_SLAB_ROWS
from continuous_clustering_tpu_torch.ops.state import init_state

from .test_pipeline import make_stream
from .test_pipeline import small_config as pipeline_config
from .test_torch_step import (HSG, assert_slabs_equal, assert_states_equal, column_blocks,
                              jax_state_numpy, one_torch_thread, scene_frames,  # noqa: F401
                              small_cfg, to_torch_block)


def with_stats(cfg):
    return cfg.replace(clustering=dataclasses.replace(
        cfg.clustering, record_neighbor_stats=True, stop_after_association_enabled=False))


def test_neighbor_stats_match_jax_every_step():
    """Two revolutions at 32 rows through ``pipeline_step_block``, the
    publish slab split into head and tail."""
    cfg = with_stats(small_cfg())
    tcfg = config_from_dataclass(cfg)
    batch, slab_cols, slab_head = 48, 128, 64
    frames = scene_frames(32, cfg.range_image.num_columns, 2, seed=5, num_boxes=6)
    js, ts = jax_init(cfg, 32), init_state(tcfg, 32, "cpu")
    jstep = jax.jit(lambda s, b, p: jax_step(cfg, s, b, p, jnp.float32(HSG), batch,
                                             slab_cols=slab_cols, slab_head=slab_head))
    counted = 0
    for k, (blk, segp) in enumerate(column_blocks(frames, batch)):
        js, jinfo = jstep(js, blk, segp)
        tblk, tseg = to_torch_block(blk, segp)
        ts, tinfo = pipeline_step_block(tcfg, ts, tblk, tseg, torch.tensor(HSG), batch,
                                        slab_cols=slab_cols, slab_head=slab_head)
        where = f"step {k}"
        assert_states_equal(jax_state_numpy(js), state_to_numpy(ts), where)
        np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                      err_msg=f"{where}: meta")
        for part in ("slab", "slab_ext"):
            jslab, tslab = np.asarray(getattr(jinfo, part)), getattr(tinfo, part).numpy()
            assert tslab.shape[0] == N_SLAB_ROWS + 1
            assert_slabs_equal(jslab[:N_SLAB_ROWS], tslab[:N_SLAB_ROWS], f"{where} {part}")
            np.testing.assert_array_equal(tslab[N_SLAB_ROWS], jslab[N_SLAB_ROWS],
                                          err_msg=f"{where} {part}: nbr_stats row")
        counted = max(counted, int((ts.nbr_stats & 0xFFFF).max()))
    # the walks visited cells and found edges
    assert counted > 0 and int((ts.nbr_stats >> 16).max()) > 0


@pytest.mark.parametrize("record", [True, False])
def test_facade_reports_neighbor_stats(monkeypatch, record):
    """Both facades on device insertion: the per-point counters of every
    published column are the same (all zero with the flag off)."""
    monkeypatch.setenv("CCT_HOST_INSERT", "0")
    cfg = pipeline_config(stop_after_association=False)
    cfg = cfg.replace(clustering=dataclasses.replace(cfg.clustering,
                                                     record_neighbor_stats=record))
    firings, poses = make_stream(num_frames=2, seed=5)

    def counters(pipe):
        pipe.reset(32)
        pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
        out = {}

        def on_col(a, b, ground_only):
            if not ground_only:
                cloud = pipe.get_columns(a, b)
                for u, v, c in zip(cloud["globally_unique_point_index"],
                                   cloud["number_of_visited_neighbors"],
                                   cloud["num_child_points"]):
                    out[int(u)] = (int(v), int(c))

        pipe.set_finished_column_callback(on_col)
        for f, p in zip(firings, poses):
            pipe.add_firing(f, p)
        pipe.flush()
        out.pop(int(np.iinfo(np.uint64).max), None)
        return out

    jax_counts = counters(JaxContinuousClustering(cfg, firing_batch_size=64))
    port_counts = counters(ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=64,
                                                device="cpu", insertion="device"))
    assert len(port_counts) > 1000
    assert port_counts == jax_counts
    assert any(v > 0 for v, _ in port_counts.values()) == record
