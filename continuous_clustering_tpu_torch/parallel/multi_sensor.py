"""Several sensor streams in one step (port of
``continuous_clustering_tpu/parallel/multi_sensor.py``).

The reference's multi-sensor deployment runs one clustering node per sensor
(three on the vehicle of ``launch/demo_touareg.launch:20-31``).  The JAX
package runs ``pipeline_step`` under ``jax.vmap`` over a leading sensor axis,
so each Pallas kernel becomes one launch for all sensors, and lets GSPMD
split that axis over a mesh's ``dp`` and each ring's columns over ``sp``.

The state carries every ``RingState`` field with a leading sensor axis
(``stacked_init``).  A step runs, per stream, the parts
of ``models/step.py::pipeline_step`` before and after association on views
of that stream's slice of the stacked state, and between them launches the
association kernels K1 and K2 once for all streams
(``ops/association.py::window_kernels``).  Insertion, segmentation and the
rest of association still run stream by stream, so their launches grow with
the number of streams.  The sensor axis is split over the ``dp`` rows of
a ``Mesh`` (``parallel/mesh.py``), each device stepping the streams of the
rows it holds; a state on one device is the one shard of a one-device
mesh.  On a mesh with sp > 1 each stream's ring columns are split over sp
too, and the step is ``parallel/halo.py::insertion_sharded_step``: the
firing loop on a gathered ``distance`` plane, each winner written to the
shard that owns its column, then the halo window's segmentation and
association, K1 and K2 again once per device for all its streams.

The ops update a state's ring and table tensors in place, so those writes
land in the stacked tensors; they re-bind the scalars and the K-slot table
(``ops/state.py``), and every field a stream re-bound is copied back into
its slice after the step.  Per stream the step computes exactly what
``pipeline_step`` computes on that stream alone, on any mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import Config
from ..models.step import EgoCalibration, StepInfo, finish_step, insert_and_segment
from ..ops.association import complete_association, window_arrays, window_kernels
from ..ops.insertion import FiringBatch
from ..ops.state import RingState, init_state
from .halo import insertion_sharded_step
from .mesh import Mesh, ShardedState, _pick, _to, stream_state

FIELDS = tuple(f.name for f in dataclasses.fields(RingState))


def stacked_init(config: Config, num_rows: int, n_sensors: int, device=None) -> RingState:
    """``n_sensors`` fresh states, every field with a leading sensor axis, on
    ``device`` (the card unless the caller names another)."""
    one = init_state(config, num_rows, torch.device("cuda" if device is None else device))
    return RingState(**{n: torch.stack([getattr(one, n)] * n_sensors) for n in FIELDS})


def _step_streams(config: Config, views: List[RingState], batches: List[FiringBatch],
                  calibs: List[EgoCalibration], batch_cols: int, slab_cols: int,
                  slab_head: int) -> List[StepInfo]:
    """One step of each stream of ``views`` (``stream_state`` views, on one
    device), K1 and K2 launched once for all; returns each stream's
    ``StepInfo``.  The fields a stream re-bound are copied back into its
    views, so every result lands in the stacked tensors."""
    bound = [{n: getattr(v, n) for n in FIELDS} for v in views]
    pre = [insert_and_segment(config, v, b, c, batch_cols)
           for v, b, c in zip(views, batches, calibs)]
    counters = [st.cluster_counter for st, _, _ in pre]
    wins = [window_arrays(config, st, gcol0, n_cols, batch_cols) for st, gcol0, n_cols in pre]
    ccs = window_kernels(config, wins)
    infos = []
    for s, ((st, gcol0, n_cols), win, cc) in enumerate(zip(pre, wins, ccs)):
        cres = complete_association(config, st, gcol0, n_cols, batch_cols, win, cc)
        st, info = finish_step(config, cres, gcol0, n_cols, counters[s], slab_cols, slab_head)
        for n, t0 in bound[s].items():
            t = getattr(st, n)
            if t is not t0:
                t0.copy_(t)
        infos.append(info)
    return infos


def make_sharded_step(config: Config, batch_cols: int, device=None, slab_cols: int = 0,
                      slab_head: int = 0, mesh: Optional[Mesh] = None):
    """The multi-sensor step: ``run(state, batch, calib) -> (state,
    StepInfo)`` with a stacked state (``stacked_init``), a ``FiringBatch`` and
    an ``EgoCalibration`` whose leaves carry the leading sensor axis.  The
    state is updated in place; every ``StepInfo`` leaf carries the sensor
    axis.  ``slab_cols``/``slab_head`` add the publish slab, as
    ``pipeline_step`` takes them.

    With ``mesh`` (``parallel/mesh.py``) the state is a ``ShardedState``
    (``shard_pytree(mesh, stacked_init(...), stacked=True)``) whose dp rows
    hold the streams, and each device steps the streams of the rows it
    holds, K1 and K2 once for all of them; the ``StepInfo`` lives on the
    mesh's first device.  Where the mesh's ``sp`` is above 1 each stream's
    ring columns are split over it (the ring's columns must split evenly),
    and after the step every shard still holds rc / sp columns
    (``parallel/halo.py::insertion_sharded_step``).  Without ``mesh`` the
    state is a stacked ``RingState`` on ``device`` (the card unless the
    caller names another), stepped as the one shard of a one-device
    mesh."""
    dev = torch.device("cuda" if device is None else device)

    def run(state, batch: FiringBatch, calib: EgoCalibration):
        if mesh is not None:
            if not isinstance(state, ShardedState) or state.mesh != mesh or not state.stacked:
                raise ValueError("with a mesh the state is shard_pytree(mesh, "
                                 "stacked_init(...), stacked=True)")
            if mesh.shape["sp"] > 1:
                return state, insertion_sharded_step(config, state, batch, calib, batch_cols,
                                                     slab_cols, slab_head)
            return state, _step_mesh(config, state, batch, calib, batch_cols, slab_cols,
                                     slab_head)
        if state.x.device.type != dev.type:
            raise ValueError(f"the state is on {state.x.device}, the step on {dev}")
        one = Mesh(((state.x.device,),))
        return state, _step_mesh(config, ShardedState(one, True, [[state]]), batch, calib,
                                 batch_cols, slab_cols, slab_head)

    return run


def _step_mesh(config: Config, state: ShardedState, batch: FiringBatch, calib: EgoCalibration,
               batch_cols: int, slab_cols: int, slab_head: int) -> StepInfo:
    """One step of every stream of a stacked ``state`` whose mesh has sp 1:
    each device steps the streams of the dp rows it holds.  Returns the
    stacked ``StepInfo`` on the mesh's first device."""
    mesh = state.mesh
    per_row = state.shards[0][0].x.shape[0]
    infos = {}
    for dev in mesh.distinct_devices():
        rows = [i for i, r in enumerate(mesh.devices) if r[0] == dev]
        ids = [i * per_row + k for i in rows for k in range(per_row)]
        views = [stream_state(state.shards[i][0], k) for i in rows for k in range(per_row)]
        got = _step_streams(config, views, [_to(_pick(batch, s), dev) for s in ids],
                            [_to(_pick(calib, s), dev) for s in ids],
                            batch_cols, slab_cols, slab_head)
        infos.update(zip(ids, got))
    out_dev = mesh.devices[0][0]
    return StepInfo(*[torch.stack([t.to(out_dev) for t in xs])
                      for xs in zip(*[infos[s] for s in sorted(infos)])])
