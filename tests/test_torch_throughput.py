"""The port's multi-step runners (``models/throughput.py``) and measurement
set-up (``tools/bench_setup.py``) on the CPU.

* ``make_scan_runner`` equals per-batch streaming through the port's
  device-insertion facade (the JAX test ``tests/test_throughput_runner.py``
  holds the JAX runner to the same bar): cell ids, frontier and counter.
* The periodic runner on blocks captured by the port's own host insertion
  equals the JAX package's ``make_periodic_block_scan_runner`` on the same
  blocks (converted through numpy), over 4 revolutions with a rebase every
  2 revolutions: every state field equal at the end (f32 fields exact
  except ``finish_az``/``slot_finish``, within the 2 ulp of XLA's f32
  arcsin, as in ``tests/test_torch_step.py``), and the per-step meta equal.
  The port runs them as two calls (3 + 1 revolutions) that continue one
  stream; the JAX runner as one.  A port stream split on the rebase
  revolution itself (2 + 2) equals the unsplit one too, and equals the JAX
  runner's uninterrupted run; the JAX runner's own continuation from that
  revolution skips the rebase (its origin ends one rebase short), so the
  two runners differ there by the JAX continuation, not by the port.
* ``measure_periodic_rate`` and ``measure_single_rate`` run their
  schedules on a small stream and keep the stream valid; the rates they
  return on the CPU are not device figures and are not checked.
  ``prepare_rev_blocks`` stacks consecutive revolutions.

The host-insertion tests need ``g++`` to build the native library and skip
without it.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.models.step import SegPoses as JaxSegPoses
from continuous_clustering_tpu.models.throughput import (
    make_periodic_block_scan_runner as jax_periodic_runner)
from continuous_clustering_tpu.ops.ingest import ColumnBlock as JaxColumnBlock
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.evaluation.synthetic import (
    frame_to_firings, make_scene, raycast_frame)
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.models.throughput import (
    make_periodic_block_scan_runner, make_scan_runner, stack_batches)
from continuous_clustering_tpu_torch.ops.state import init_state
from continuous_clustering_tpu_torch.tools import bench_setup

from .test_pipeline import small_config
from .test_torch_step import assert_states_equal, jax_state_numpy, one_torch_thread  # noqa: F401

NUM_ROWS, NUM_COLS = 16, 110


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")


def tiny_config():
    cfg = small_config()
    return config_from_dataclass(cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=NUM_COLS, ring_buffer_revolutions=4)))


def cell_ids(state) -> np.ndarray:
    slots = state.slot.numpy()
    res = state.slot_parent.numpy()[np.maximum(slots, 0)]
    return np.where(slots >= 0, state.slot_cid.numpy()[res], 0)


def test_scan_runner_matches_streaming():
    cfg = tiny_config()
    scene = make_scene(num_boxes=4, seed=1, spread=15.0)
    xyz, _ = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS, seed=1)

    def fresh():
        p = ContinuousClustering(cfg, firing_batch_size=55, device="cpu", insertion="device")
        p.reset(NUM_ROWS)
        p.set_transform_robot_frame_from_sensor_frame(np.eye(4))
        return p

    pipe = fresh()
    for rev in range(2):
        for f in frame_to_firings(xyz, frame_index=rev):
            pipe.add_firing(f, np.eye(4))
    # no flush: both sides ran exactly the same steps

    p2 = fresh()
    firings = frame_to_firings(xyz)
    per_step = [p2._make_batch(firings[s:s + 55], [np.eye(4)] * len(firings[s:s + 55]))
                for s in range(0, NUM_COLS, 55)]
    stacked = stack_batches(per_step)
    runner = make_scan_runner(cfg, p2._batch_B)
    state = p2.state
    for _ in range(2):
        state, infos = runner(state, stacked, p2._make_calib())
    assert infos.meta.shape[0] == len(per_step)
    assert not bool(state.overflow)
    assert int(state.first_unpublished) == pipe.first_unpublished_global_column_index
    assert int(state.cluster_counter) == pipe._h_cluster_counter
    np.testing.assert_array_equal(cell_ids(state), cell_ids(pipe.state))


def to_jax(blocks, seg_poses):
    """The port's stacked ColumnBlock and SegPoses as the JAX package's."""
    kw = {}
    for name in JaxColumnBlock._fields:
        a = getattr(blocks, name).numpy()
        kw[name] = jnp.asarray(a.view(np.uint32) if name in (
            "stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi") else a)
    return JaxColumnBlock(**kw), JaxSegPoses(*[jnp.asarray(t.numpy()) for t in seg_poses])


REVS, EVERY = 4, 2  # revolutions of the periodic runs, rebase every EVERY


@pytest.fixture(scope="module")
def periodic_runs():
    """The captured revolution, the JAX runner's uninterrupted run over
    ``REVS`` revolutions (k0 = 0), and the port's runner over a split."""
    needs_gxx()
    jcfg = small_config().replace(range_image=dataclasses.replace(
        small_config().range_image, num_columns=NUM_COLS, ring_buffer_revolutions=4))
    cfg = config_from_dataclass(jcfg)
    scene = make_scene(num_boxes=4, seed=1, spread=15.0)
    xyz, _ = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS, seed=1)
    firings = frame_to_firings(xyz, start_stamp=0, end_stamp=10**8)
    pipe = ContinuousClustering(cfg, firing_batch_size=55, device="cpu")
    pipe.reset(NUM_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    blocks0, segp0, per_rev, hsg = bench_setup.capture_revolution(pipe, firings, NUM_COLS)
    assert per_rev >= 2
    jblocks0, jsegp0 = to_jax(blocks0, segp0)

    def jax_stream(split):
        js, k0, metas = jax_init(jcfg, NUM_ROWS), 0, []
        for n in split:
            jr = jax.jit(jax_periodic_runner(jcfg, pipe._batch_B, NUM_COLS, n * per_rev,
                                             reduce_infos=False, rebase_every=EVERY))
            js, jinfos = jr(js, jblocks0, jsegp0, jnp.asarray(np.float32(hsg)), jnp.int32(k0))
            metas.append(np.asarray(jinfos.meta))
            k0 += n * per_rev
        return js, np.concatenate(metas)

    def port_stream(split):
        state, k0, metas = init_state(cfg, NUM_ROWS, "cpu"), 0, []
        for n in split:
            run = make_periodic_block_scan_runner(cfg, pipe._batch_B, NUM_COLS, n * per_rev,
                                                  reduce_infos=False, rebase_every=EVERY)
            state, infos = run(state, blocks0, segp0, hsg, k0)
            metas.append(infos.meta)
            k0 += n * per_rev
        return state, torch.cat(metas)

    return jax_stream((REVS,)), port_stream, jax_stream


def test_periodic_runner_matches_jax_across_rebase(periodic_runs):
    (js, jmeta), port_stream, _ = periodic_runs
    ts, tmeta = port_stream((3, 1))
    np.testing.assert_array_equal(tmeta.numpy(), jmeta)
    assert_states_equal(jax_state_numpy(js), state_to_numpy(ts), "after 4 revolutions")
    assert int(ts.origin_rot) == EVERY and int(tmeta[:, 4].sum()) > 0
    assert not bool(ts.overflow) and not bool(ts.cc_failed)
    assert (REVS - 2) * NUM_COLS < int(ts.first_unpublished) <= REVS * NUM_COLS

    ts2, tmeta2 = port_stream((2, 2))
    assert torch.equal(tmeta2, tmeta)
    for name, a in state_to_numpy(ts2).items():
        np.testing.assert_array_equal(a, state_to_numpy(ts)[name], err_msg=name)


def test_periodic_runner_split_on_a_rebase_revolution(periodic_runs):
    """A stream split exactly on the rebase revolution (2 + 2, rebase every
    2): the port's continuation equals the JAX runner's uninterrupted run
    (k0 = 0), every step's meta and every state field.  The JAX runner's own
    continuation from k0 = 2 revolutions starts from the shift as of that
    step and so skips the rebase: its origin stays a rebase behind the
    uninterrupted run's, which the port's does not."""
    (js, jmeta), port_stream, jax_stream = periodic_runs
    ts, tmeta = port_stream((2, 2))
    np.testing.assert_array_equal(tmeta.numpy(), jmeta)
    assert_states_equal(jax_state_numpy(js), state_to_numpy(ts), "split 2 + 2")
    assert int(ts.origin_rot) == int(js.origin_rot) == EVERY

    js_split, _ = jax_stream((2, 2))
    assert int(js_split.origin_rot) == int(js.origin_rot) - EVERY


def test_measure_periodic_rate_keeps_the_stream_valid():
    needs_gxx()
    cfg, pipe = bench_setup.make_bench_pipe(num_rows=NUM_ROWS, num_cols=NUM_COLS,
                                            ring_revs=4, batch=55, nth=1, device="cpu")
    firings, n_points = bench_setup.make_bench_scene(NUM_ROWS, NUM_COLS, "near_field")
    scene = bench_setup.capture_revolution(pipe, firings, NUM_COLS)
    res = bench_setup.measure_periodic_rate(cfg, pipe, scene, NUM_COLS, n_points, N=1,
                                            pairs=1, slab_cols=pipe._slab_W,
                                            slab_head=pipe._slab_W1)
    total_revs = res["k0"] // res["per_rev"]
    assert total_revs == 6
    assert int(res["state"].first_unpublished) > (total_revs - 3) * NUM_COLS
    assert not res["overflow"] and not res["cc_failed"]
    assert isinstance(res["checksum"], int) and len(res["t2s_ms"]) == 1
    assert int(res["state"].cluster_counter) > 1


def test_single_rate_and_revolution_blocks():
    """``measure_single_rate`` keeps the stream valid, and
    ``prepare_rev_blocks`` stacks consecutive host-inserted revolutions."""
    needs_gxx()
    cfg, pipe = bench_setup.make_bench_pipe(num_rows=NUM_ROWS, num_cols=NUM_COLS,
                                            ring_revs=4, batch=55, nth=1, device="cpu")
    firings, n_points = bench_setup.make_bench_scene(NUM_ROWS, NUM_COLS, "clutter")
    scene = bench_setup.capture_revolution(pipe, firings, NUM_COLS)
    res = bench_setup.measure_single_rate(cfg, pipe, scene, NUM_COLS, n_points, N=1, calls=1)
    assert not res["overflow"] and not res["cc_failed"] and len(res["t_ms"]) == 1

    _, pipe2 = bench_setup.make_bench_pipe(num_rows=NUM_ROWS, num_cols=NUM_COLS,
                                           ring_revs=4, batch=55, nth=1, device="cpu")
    revs, hsg = bench_setup.prepare_rev_blocks(pipe2, firings, 2, NUM_COLS)
    assert len(revs) == 3 and float(hsg) == float(bench_setup.HSG)
    starts = [int(blocks.gcol0[0]) for blocks, _ in revs]
    assert all(abs(b - a - NUM_COLS) <= 2 for a, b in zip(starts, starts[1:])), starts


def test_entry_points_default_to_the_card():
    """``device=None`` is the card; without one there is no fallback to the
    CPU: allocating the state fails."""
    cfg = tiny_config()
    pipe = ContinuousClustering(cfg, insertion="device")
    assert pipe._device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pipe.reset(NUM_ROWS)
        with pytest.raises((RuntimeError, AssertionError)):
            bench_setup.make_bench_pipe(num_rows=NUM_ROWS, num_cols=NUM_COLS, ring_revs=4,
                                        batch=55)
    with pytest.raises(ValueError, match="insertion"):
        ContinuousClustering(cfg, insertion="gpu")
