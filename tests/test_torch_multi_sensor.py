"""The port's multi-sensor step (``parallel/multi_sensor.py``) against the JAX
package's and against the port's own single-stream step, on the CPU.

Two cases, F = 55 firings per step: S = 3 distinct scenes at 16 x 110 for 4
steps (the shapes of ``tests/test_parallel.py``), and S = 2 streams at
32 x 220 for 8 steps, one of them a fork (two bands of rows that a bar
joins every 60 columns) whose components merge across steps, so the
union's slot table leaves the identity.  Both packages get the same
batches, made with numpy.  Comparison rule, fixed before the first
comparison:

* against the JAX ``make_sharded_step`` (on a one-device mesh), per sensor
  after every step: every state field by the device-insertion rule of
  ``tests/test_torch_insertion.py::compare_states`` (integer and boolean
  fields, the slot table and the scalars exact; f32 fields exact except
  where an f32 transcendental enters: ``finish_az``/``slot_finish`` within
  the 2 ulp of XLA's arcsin, and the azimuth-derived fields within the
  bounds stated there), and every meta lane exactly except ``cc_rounds``
  (it follows the sweep schedule, which differs from the JAX package's);
* against the port's ``pipeline_step`` run on each stream alone: every
  state field and every meta lane, ``cc_rounds`` included, bit for bit.

The demo tool (``tools/multi_sensor_demo.py``) runs on the CPU at 16 x 110
with 2 sensors in both of its modes and prints the JAX tool's keys.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.parallel.mesh import make_mesh
from continuous_clustering_tpu.parallel.multi_sensor import make_sharded_step as jax_sharded_step
from continuous_clustering_tpu.parallel.multi_sensor import stacked_init as jax_stacked_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.models.step import META_CC_ROUNDS, EgoCalibration, pipeline_step
from continuous_clustering_tpu_torch.ops.insertion import FiringBatch
from continuous_clustering_tpu_torch.ops.state import init_state
from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                   stacked_init, stream_state)
from continuous_clustering_tpu_torch.utils import stats

from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)

from .test_parallel import F, NUM_ROWS, calib, make_batches, small_cfg
from .test_torch_insertion import compare_states, to_jax, torch_batch
from .test_torch_insertion import small_config as wide_cfg
from .test_torch_step import jax_state_numpy, one_torch_thread  # noqa: F401

B = F + 32
U32 = ("stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi")


def to_torch(batch) -> FiringBatch:
    """A JAX FiringBatch as the port's, through numpy (u32 as i32 bits)."""
    return FiringBatch(**{
        name: torch.from_numpy(np.array(np.asarray(getattr(batch, name)).view(np.int32)
                                        if name in U32 else np.asarray(getattr(batch, name))))
        for name in FiringBatch._fields})


def torch_calib() -> EgoCalibration:
    c = calib()
    return EgoCalibration(*[torch.from_numpy(np.array(np.asarray(t))) for t in c])


def stack(items):
    return type(items[0])(*[torch.stack(xs) for xs in zip(*items)])


def fork_firings(num_rows=32, num_cols=220, dist=6.0, n_rev=2):
    """Firings of a fork at ``dist`` m: rows 1-2 and 9-10 over the whole
    rotation, joined by a bar over rows 1-10 every 60 columns."""
    inc = np.deg2rad(np.linspace(2.0, -24.8, num_rows))
    az = np.pi - np.arange(num_cols) * (2.0 * np.pi / num_cols)
    xyz = np.full((num_cols, num_rows, 3), np.nan, np.float32)
    for c in range(num_cols):
        for r in (range(1, 11) if c % 60 == 59 else (1, 2, 9, 10)):
            xyz[c, r] = dist * np.array([np.cos(inc[r]) * np.cos(az[c]),
                                         np.cos(inc[r]) * np.sin(az[c]), np.sin(inc[r])])
    return sum((frame_to_firings(xyz, frame_index=rev) for rev in range(n_rev)), [])


def scene_firings(seed, num_rows=32, num_cols=220, n_rev=2):
    scene = make_scene(num_boxes=8, seed=seed, spread=14.0)
    return sum((frame_to_firings(raycast_frame(scene, num_rows=num_rows, num_columns=num_cols,
                                               seed=seed + rev)[0], frame_index=rev)
                for rev in range(n_rev)), [])


def case_inputs(case):
    """(JAX config, number of rows, per stream: the JAX and the port's
    firing batches of every step)."""
    if case == "parallel-shapes":
        batches = [make_batches(seed=7 + s, n_steps=4) for s in range(3)]
        return small_cfg(), NUM_ROWS, [[(b, to_torch(b)) for b in per] for per in batches]
    eye = np.eye(4)
    streams = []
    for firings in (fork_firings(), scene_firings(seed=11)):
        per = []
        for k in range(0, len(firings), F):
            batch = torch_batch(firings[k:k + F], [eye] * len(firings[k:k + F]), F)
            per.append((to_jax(batch), batch))
        streams.append(per)
    return wide_cfg(), 32, streams


@pytest.mark.parametrize("case", ["parallel-shapes", "merging"])
def test_multi_sensor_step_matches_jax_and_single_streams(case):
    cfg, num_rows, streams = case_inputs(case)
    tcfg = config_from_dataclass(cfg)
    S, n_steps = len(streams), len(streams[0])

    jstate = jax_stacked_init(cfg, num_rows, S)
    jrun = jax_sharded_step(cfg, make_mesh(1), batch_cols=B)
    scalib = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[calib() for _ in range(S)])
    tstate = stacked_init(tcfg, num_rows, S, "cpu")
    trun = make_sharded_step(tcfg, B, device="cpu")
    tcal = stack([torch_calib() for _ in range(S)])
    stats.reset_launch_counts()
    metas, published, merged = [], 0, 0
    for k in range(n_steps):
        sbatch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[st[k][0] for st in streams])
        jstate, jinfo = jrun(jstate, sbatch, scalib)
        tstate, tinfo = trun(tstate, stack([st[k][1] for st in streams]), tcal)
        js, ts = jax_state_numpy(jstate), state_to_numpy(tstate)
        jmeta, tmeta = np.asarray(jinfo.meta), tinfo.meta.numpy()
        assert tmeta.shape == jmeta.shape == (S, 10)
        lanes = [i for i in range(tmeta.shape[1]) if i != META_CC_ROUNDS]
        for s in range(S):
            where = f"step {k}, sensor {s}"
            compare_states({n: a[s] for n, a in js.items()}, {n: a[s] for n, a in ts.items()},
                           where)
            np.testing.assert_array_equal(tmeta[s, lanes], jmeta[s, lanes],
                                          err_msg=f"{where}: meta")
        metas.append(tinfo.meta.clone())
        published += int((tinfo.num_new_clusters > 0).sum())
        merged += int((tstate.slot_parent != torch.arange(tstate.slot_parent.shape[1])).sum())
    assert published > 0 and not bool(tstate.overflow.any())
    assert (merged > 0) == (case == "merging")
    # on the CPU the wrappers take the twins: nothing is launched
    assert stats.LAUNCHES == {"edge_bits": 0, "window_cc": 0, "ground_segment": 0,
                              "sweep_probe": 0}

    final = state_to_numpy(tstate)
    for s in range(S):
        st = init_state(tcfg, num_rows, "cpu")
        for k in range(n_steps):
            st, info = pipeline_step(tcfg, st, streams[s][k][1], torch_calib(), B)
            np.testing.assert_array_equal(info.meta.numpy(), metas[k][s].numpy(),
                                          err_msg=f"step {k}, sensor {s}: meta")
        for name, a in state_to_numpy(st).items():
            np.testing.assert_array_equal(final[name][s], a, err_msg=f"sensor {s}: {name}")


def test_stream_state_views_the_stacked_state():
    """A stream's state is made of views: an in-place write lands in the
    stacked tensors, a re-bound field does not (the step copies those back)."""
    cfg = config_from_dataclass(small_cfg())
    state = stacked_init(cfg, NUM_ROWS, 2, "cpu")
    one = stream_state(state, 1)
    one.x.fill_(1.0)
    one.cluster_counter = torch.tensor(7, dtype=torch.int32)
    assert bool((state.x[1] == 1.0).all()) and bool(state.x[0].isnan().all())
    assert state.cluster_counter.tolist() == [1, 1]
    assert all(getattr(state, n).shape[0] == 2 for n in ("x", "slot_parent", "origin_rot"))


# the keys of the JAX tool's JSON line (continuous_clustering_tpu/tools/
# multi_sensor_demo.py), per mode
JAX_TOOL_KEYS = {"host-parallel": {"sensors", "clusters_per_sensor", "points_per_second", "mode"},
                 "sharded": {"sensors", "mesh", "total_new_clusters", "wall_s", "mode"}}


@pytest.mark.parametrize("mode", ["host-parallel", "sharded"])
def test_demo_prints_the_jax_tools_line(capsys, mode):
    from continuous_clustering_tpu_torch.tools.multi_sensor_demo import main

    if mode == "host-parallel" and shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    argv = ["--sensors", "2", "--rows", "16", "--columns", "110", "--device", "cpu"]
    result = main(argv + (["--sharded"] if mode == "sharded" else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert set(line) == JAX_TOOL_KEYS[mode] | {"device"}
    assert line["mode"] == mode and line["sensors"] == 2 and line["device"] == "cpu"
    if mode == "sharded":
        assert line["mesh"] == {"dp": 1, "sp": 1} and line["total_new_clusters"] > 0
    else:
        assert len(line["clusters_per_sensor"]) == 2 and min(line["clusters_per_sensor"]) > 0
