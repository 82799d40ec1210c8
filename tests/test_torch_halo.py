"""The port's column-sharded halo step (``parallel/halo.py``) and meshes
(``parallel/mesh.py``) against the JAX package's and against the port's own
unsharded step, on the CPU.

The port's counterparts of the three ``tests/test_halo.py`` cases, and the
multi-sensor step on meshes of ``tests/test_parallel.py``'s shapes, dp 2 x
sp 1 and dp 2 x sp 4 (device insertion into column shards), against the
JAX ``make_sharded_step`` on ``make_mesh(8)``.  Blocks
are captured once with the port's host insertion (the JAX test captures
them with the JAX ``HostInsertion``, which needs the JAX package's native
library built) at 110 columns, a ring of 4 revolutions and firing batch
55, over 5 revolutions, so the ring wraps and the chunk clear's gcol gate
decides which cells survive.  The same blocks, converted through numpy, go
to the JAX ``make_halo_sharded_step`` on the 8 virtual CPU devices
(``tests/conftest.py``), to the port's halo step with every shard on the
CPU, and to the port's unsharded ``pipeline_step_block``.

Tolerance, fixed before the first comparison:

* the port's halo step against the port's unsharded step: exact, every
  state field (ring, slot table, scalars; f32 fields bit for bit up to the
  NaN payload), every step's meta, slab head and slab tail;
* the port's halo step against the JAX halo step: the rule of
  ``tests/test_torch_step.py``, exact except ``finish_az``/``slot_finish``
  within the 2 ulp of XLA's f32 arcsin (and the slab's ``finish_az`` row);
  the meta (``cc_rounds`` included) and the join tables exactly.

One JAX compile per case.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from continuous_clustering_tpu.config import kitti_config
from continuous_clustering_tpu.parallel.halo import make_halo_sharded_step as jax_halo_step
from continuous_clustering_tpu.parallel.halo import place_state as jax_place_state
from continuous_clustering_tpu.parallel.mesh import make_mesh as jax_make_mesh
from continuous_clustering_tpu.parallel.multi_sensor import make_sharded_step as jax_sharded_step
from continuous_clustering_tpu.parallel.multi_sensor import stacked_init as jax_stacked_init
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.models.step import META_CC_ROUNDS, pipeline_step_block
from continuous_clustering_tpu_torch.ops.state import init_state
from continuous_clustering_tpu_torch.parallel.halo import make_halo_sharded_step
from continuous_clustering_tpu_torch.parallel.mesh import (Mesh, ShardedState, gather_state,
                                                           make_mesh, shard_pytree)
from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                   stacked_init)
from continuous_clustering_tpu_torch.tools.bench_setup import _insert_revolution

from .test_parallel import F, NUM_ROWS, calib, make_batches, small_cfg
from .test_torch_insertion import compare_states
from .test_torch_multi_sensor import stack, to_torch, torch_calib
from .test_torch_step import (assert_slabs_equal, assert_states_equal, jax_state_numpy,
                              one_torch_thread)  # noqa: F401
from .test_torch_throughput import to_jax

NUM_COLS, BATCH, N_REV = 110, 55, 5
HSG = np.float32(-1.5)
W, W1 = 128, 64  # publish slab and its head, as tests/test_halo.py


def jax_cfg():
    cfg = kitti_config()
    return cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=NUM_COLS, ring_buffer_revolutions=4))


def capture(cfg, num_rows, seed=1, n_rev=N_REV):
    """The port's host-inserted (ColumnBlock, SegPoses) steps of ``n_rev``
    revolutions of one scene, on the CPU; and the step width B."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    pipe = ContinuousClustering(cfg, firing_batch_size=BATCH, device="cpu")
    pipe.reset(num_rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    scene = make_scene(num_boxes=5, seed=seed, spread=18.0)
    steps = []
    for rev in range(n_rev):
        xyz, _ = raycast_frame(scene, num_rows=num_rows, num_columns=NUM_COLS, seed=seed + rev)
        blocks, segps = _insert_revolution(pipe, frame_to_firings(xyz, frame_index=rev),
                                           NUM_COLS)
        steps += zip(blocks, segps)
    assert int(steps[-1][0].gcol0) + BATCH > cfg.ring_buffer_max_columns, "no ring wrap"
    return steps, pipe._batch_B


def cpu_mesh(dp, nsp) -> Mesh:
    return make_mesh(devices=["cpu"] * (dp * nsp), dp=dp)


def jax_mesh(dp, nsp) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[:dp * nsp]).reshape(dp, nsp), ("dp", "sp"))


def assert_exact(a: dict, b: dict, where: str) -> None:
    for name, x in a.items():
        np.testing.assert_array_equal(b[name], x, err_msg=f"{where}: {name}")


def compare_infos(tinfo, uinfo, jinfo, where, slab):
    """The halo step's StepInfo against the unsharded one (exact) and the
    JAX halo step's (meta exact, slab by the ulp rule)."""
    for part in ("meta", "slab", "slab_ext"):
        assert torch.equal(getattr(tinfo, part), getattr(uinfo, part)), f"{where}: {part}"
    np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                  err_msg=f"{where}: meta vs JAX")
    if slab:
        for part in ("slab", "slab_ext"):
            assert_slabs_equal(np.asarray(getattr(jinfo, part)), getattr(tinfo, part).numpy(),
                               f"{where} {part} vs JAX")


@pytest.mark.parametrize("nsp,num_rows,slab", [(4, 64, False), (8, 64, False), (4, 32, True)],
                         ids=["nsp4", "nsp8", "nsp4-slab"])
def test_halo_step_matches_jax_and_unsharded(nsp, num_rows, slab):
    """nsp 4 and 8 at 64 rows (tests/test_halo.py::test_halo_sharded_matches_
    unsharded) and the publish slab at 32 rows (::test_halo_sharded_slab_
    matches_unsharded), every step."""
    jcfg = jax_cfg()
    cfg = config_from_dataclass(jcfg)
    steps, B = capture(cfg, num_rows)
    sc, sh = (W, W1) if slab else (0, 0)
    hsg = torch.tensor(HSG)

    jrun = jax_halo_step(jcfg, jax_mesh(1, nsp), B, slab_cols=sc, slab_head=sh)
    js = jax_place_state(jax_mesh(1, nsp), jax_init(jcfg, num_rows))
    run = make_halo_sharded_step(cfg, cpu_mesh(1, nsp), B, slab_cols=sc, slab_head=sh)
    ts = shard_pytree(cpu_mesh(1, nsp), init_state(cfg, num_rows, "cpu"), stacked=False)
    us = init_state(cfg, num_rows, "cpu")
    published = 0
    for k, (blk, segp) in enumerate(steps):
        js, jinfo = jrun(js, *to_jax(blk, segp), jnp.float32(HSG))
        ts, tinfo = run(ts, blk, segp, hsg)
        us, uinfo = pipeline_step_block(cfg, us, blk, segp, hsg, B, sc, sh)
        compare_infos(tinfo, uinfo, jinfo, f"step {k}", slab)
        published += int(tinfo.num_new_clusters) > 0
    assert published > 0
    halo = state_to_numpy(gather_state(ts))
    assert_exact(state_to_numpy(us), halo, "halo vs unsharded")
    assert_states_equal(jax_state_numpy(js), halo, "halo vs JAX halo")
    assert not halo["overflow"] and int(halo["ring_start"]) > 0


def test_halo_step_stacked_dp_matches_jax_and_unsharded():
    """Two sensor streams split over dp = 2, each ring over nsp = 4
    (tests/test_halo.py::test_halo_sharded_stacked_dp); every field of each
    stream, and each step's meta."""
    jcfg = jax_cfg()
    cfg = config_from_dataclass(jcfg)
    num_rows, nsp = 32, 4
    (s1, B), (s2, _) = capture(cfg, num_rows, seed=1), capture(cfg, num_rows, seed=9)
    n = min(len(s1), len(s2))
    hsg = torch.tensor(HSG)

    jrun = jax_halo_step(jcfg, jax_mesh(2, nsp), B, stacked=True)
    jstack = lambda *trees: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    js = jax_place_state(jax_mesh(2, nsp), jstack(*[jax_init(jcfg, num_rows)] * 2), stacked=True)
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": nsp}
    run = make_halo_sharded_step(cfg, mesh, B, stacked=True)
    ts = shard_pytree(mesh, stacked_init(cfg, num_rows, 2, "cpu"), stacked=True)
    us = [init_state(cfg, num_rows, "cpu") for _ in range(2)]
    for k in range(n):
        pairs = [s1[k], s2[k]]
        js, jinfo = jrun(js, *[jstack(*xs) for xs in zip(*[to_jax(*p) for p in pairs])],
                         jnp.stack([jnp.float32(HSG)] * 2))
        ts, tinfo = run(ts, stack([p[0] for p in pairs]), stack([p[1] for p in pairs]),
                        torch.stack([hsg, hsg]))
        np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                      err_msg=f"step {k}: meta vs JAX")
        for s, (blk, segp) in enumerate(pairs):
            us[s], uinfo = pipeline_step_block(cfg, us[s], blk, segp, hsg, B)
            assert torch.equal(tinfo.meta[s], uinfo.meta), f"step {k}, stream {s}: meta"
    halo, jhalo = state_to_numpy(gather_state(ts)), jax_state_numpy(js)
    for s in range(2):
        one = {name: a[s] for name, a in halo.items()}
        assert_exact(state_to_numpy(us[s]), one, f"stream {s}: halo vs unsharded")
        assert_states_equal({name: a[s] for name, a in jhalo.items()}, one,
                            f"stream {s}: halo vs JAX halo")
    assert [int(c) for c in halo["cluster_counter"]] != [1, 1]


def test_mesh_rules_and_state_round_trip():
    """make_mesh follows the JAX rule (dp = 2 for an even count above 1);
    shard_pytree/gather_state round-trip a state, stacked or not, with every
    shard owning its slice on its device; no card, no default mesh."""
    shapes = {n: make_mesh(devices=["cpu"] * n).shape for n in (1, 3, 6, 8)}
    assert shapes == {1: {"dp": 1, "sp": 1}, 3: {"dp": 1, "sp": 3}, 6: {"dp": 2, "sp": 3},
                      8: {"dp": 2, "sp": 4}}
    assert {n: dict(jax_make_mesh(n).shape) for n in (1, 6, 8)} == {
        n: shapes[n] for n in (1, 6, 8)}
    assert make_mesh(4, dp=1, devices=["cpu"] * 8).shape == {"dp": 1, "sp": 4}
    with pytest.raises(ValueError):
        make_mesh(dp=4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()

    cfg = config_from_dataclass(jax_cfg())
    rng = np.random.default_rng(0)
    one = init_state(cfg, 8, "cpu")
    for name in ("x", "gcol", "slot_parent", "incl_diffs", "ring_start"):
        t = getattr(one, name)
        t.copy_(torch.from_numpy(rng.integers(-5, 100, t.shape)).to(t.dtype))
    two = stacked_init(cfg, 8, 2, "cpu")
    two.x[1] = 7.0
    for state, stacked, (dp, nsp) in ((one, False, (2, 4)), (two, True, (2, 4)),
                                      (one, False, (1, 8))):
        mesh = cpu_mesh(dp, nsp)
        sh = shard_pytree(mesh, state, stacked=stacked)
        assert isinstance(sh, ShardedState) and len(sh.shards) == dp
        lead = (1,) if stacked else ()
        for row in sh.shards:
            for j, part in enumerate(row):
                assert part.x.shape == lead + (8, cfg.ring_buffer_max_columns // nsp)
                assert part.slot_parent.shape == lead + state.slot_parent.shape[int(stacked):]
                assert part.x.data_ptr() != state.x.data_ptr()
        back = state_to_numpy(gather_state(sh))
        assert_exact(state_to_numpy(state), back, f"round trip dp={dp} sp={nsp}")
    assert shard_pytree(cpu_mesh(2, 1), two).shards[1][0].x.eq(7.0).all()
    with pytest.raises(ValueError, match="does not split"):
        shard_pytree(cpu_mesh(1, 3), one, stacked=False)


def test_multi_sensor_step_on_a_dp_mesh_matches_jax():
    """``make_sharded_step(mesh=...)`` with the streams split over dp = 2,
    on a mesh with sp 1 and on one whose ring columns are split over sp = 4
    (device insertion into a column-sharded ring), against the JAX
    ``make_sharded_step`` on ``make_mesh(8)`` (dp 2, sp 4), by the rule of
    tests/test_torch_multi_sensor.py (meta without ``cc_rounds``, state by
    the device-insertion rule), and exactly against the port's one-device
    multi-sensor step: every step's meta, slab and tail, and at the end
    every field.  11 steps of 55 firings wrap the ring of 440 columns."""
    jcfg = small_cfg()
    cfg = config_from_dataclass(jcfg)
    S, n_steps, JB = 4, 11, F + 32
    batches = [make_batches(seed=7 + s, n_steps=n_steps) for s in range(S)]
    jrun = jax_sharded_step(jcfg, jax_make_mesh(8), batch_cols=JB)
    jstate = jax_stacked_init(jcfg, NUM_ROWS, S)
    jcal = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[calib()] * S)

    mesh = make_mesh(2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": 1}
    meshes = [mesh, cpu_mesh(2, 4)]
    runs = [make_sharded_step(cfg, JB, mesh=m) for m in meshes]
    states = [shard_pytree(m, stacked_init(cfg, NUM_ROWS, S, "cpu"), stacked=True)
              for m in meshes]
    one_run = make_sharded_step(cfg, JB, device="cpu")
    one = stacked_init(cfg, NUM_ROWS, S, "cpu")
    tcal = stack([torch_calib()] * S)
    lanes = [i for i in range(10) if i != META_CC_ROUNDS]
    for k in range(n_steps):
        jbatch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[b[k] for b in batches])
        jstate, jinfo = jrun(jstate, jbatch, jcal)
        tbatch = stack([to_torch(b[k]) for b in batches])
        one, oinfo = one_run(one, tbatch, tcal)
        for m, (run, state) in enumerate(zip(runs, states)):
            state, tinfo = run(state, tbatch, tcal)
            where = f"step {k}, mesh {meshes[m].shape}"
            for part in ("meta", "slab", "slab_ext"):
                assert torch.equal(getattr(tinfo, part), getattr(oinfo, part)), f"{where}: {part}"
            np.testing.assert_array_equal(tinfo.meta.numpy()[:, lanes],
                                          np.asarray(jinfo.meta)[:, lanes], err_msg=where)
    assert int(tbatch.valid.sum()) > 0 and int(one.ring_start.min()) > 0
    assert int(oinfo.gcol0.min()) + JB > cfg.ring_buffer_max_columns, "no ring wrap"
    js = jax_state_numpy(jstate)
    for m, state in enumerate(states):
        ts = state_to_numpy(gather_state(state))
        assert_exact(state_to_numpy(one), ts, f"mesh {meshes[m].shape} vs one device")
        for s in range(S):
            compare_states({n: a[s] for n, a in js.items()}, {n: a[s] for n, a in ts.items()},
                           f"mesh {meshes[m].shape}, sensor {s}")
    assert states[1].shards[1][3].x.shape == (2, NUM_ROWS, cfg.ring_buffer_max_columns // 4)


def test_halo_clear_keeps_fresher_cells_as_the_unsharded_clear():
    """The chunk clear's gcol gate: cells in the range the next step clears
    that hold a fresher column (a legal overwrite) survive, on the halo
    path as in ``ops.state.clear_columns_chunk``.  Both paths start from
    the same state with such cells planted; every field stays equal."""
    cfg = config_from_dataclass(jax_cfg())
    num_rows, nsp = 32, 4
    steps, B = capture(cfg, num_rows, n_rev=4)
    hsg = torch.tensor(HSG)
    mesh = cpu_mesh(1, nsp)
    run = make_halo_sharded_step(cfg, mesh, B)
    us = init_state(cfg, num_rows, "cpu")
    rc = cfg.ring_buffer_max_columns
    planted = None
    for k, (blk, segp) in enumerate(steps):
        if planted is None and int(us.ring_start) > 0:   # the clear has begun
            # the first two columns the next step clears: rows 0-3 hold a
            # column one ring ahead of the one the clear expects there
            planted = int(us.ring_start)
            cols = torch.tensor([planted % rc, (planted + 1) % rc])
            us.gcol[:4, cols] = torch.tensor([planted + rc, planted + 1 + rc], dtype=torch.int32)
            us.x[:4, cols] = 12.5
            ts = shard_pytree(mesh, us, stacked=False)
        us, uinfo = pipeline_step_block(cfg, us, blk, segp, hsg, B)
        if planted is not None:
            ts, tinfo = run(ts, blk, segp, hsg)
            assert torch.equal(tinfo.meta, uinfo.meta), f"step {k}: meta"
    assert planted is not None and int(us.ring_start) > planted + 1
    kept = us.x[:4, torch.tensor([planted % rc, (planted + 1) % rc])]
    assert bool((kept == 12.5).all()), "the planted cells were cleared"
    assert_exact(state_to_numpy(us), state_to_numpy(gather_state(ts)), "halo vs unsharded")
