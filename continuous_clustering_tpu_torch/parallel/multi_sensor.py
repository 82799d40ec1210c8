"""Several sensor streams in one step on one device (port of
``continuous_clustering_tpu/parallel/multi_sensor.py``).

The reference's multi-sensor deployment runs one clustering node per sensor
(three on the vehicle of ``launch/demo_touareg.launch:20-31``).  The JAX
package runs ``pipeline_step`` under ``jax.vmap`` over a leading sensor axis,
so each Pallas kernel becomes one launch for all sensors, and shards that
axis over a device mesh.

The port runs on one card.  The state carries every ``RingState`` field with
a leading sensor axis (``stacked_init``).  A step runs, per stream, the parts
of ``models/step.py::pipeline_step`` before and after association on views
of that stream's slice of the stacked state, and between them launches the
association kernels K1 and K2 once for all streams
(``ops/association.py::window_kernels``).  Insertion, segmentation and the
rest of association still run stream by stream, so their launches grow with
the number of streams.  The JAX ``Mesh`` argument has no counterpart: the
sensor axis stays on one card until the port spreads it over several.

The ops update a state's ring and table tensors in place, so those writes
land in the stacked tensors; they re-bind the scalars and the K-slot table
(``ops/state.py``), and every field a stream re-bound is copied back into
its slice after the step.  Per stream the step computes exactly what
``pipeline_step`` computes on that stream alone.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import Config
from ..models.step import EgoCalibration, StepInfo, finish_step, insert_and_segment
from ..ops.association import complete_association, window_arrays, window_kernels
from ..ops.insertion import FiringBatch
from ..ops.state import RingState, init_state

FIELDS = tuple(f.name for f in dataclasses.fields(RingState))


def stacked_init(config: Config, num_rows: int, n_sensors: int, device=None) -> RingState:
    """``n_sensors`` fresh states, every field with a leading sensor axis, on
    ``device`` (the card unless the caller names another)."""
    one = init_state(config, num_rows, torch.device("cuda" if device is None else device))
    return RingState(**{n: torch.stack([getattr(one, n)] * n_sensors) for n in FIELDS})


def stream_state(state: RingState, s: int) -> RingState:
    """Stream ``s`` of a stacked state: views of its slices."""
    return RingState(**{n: getattr(state, n)[s] for n in FIELDS})


def _pick(stacked: NamedTuple, s: int):
    return type(stacked)(*[t[s] for t in stacked])


def make_sharded_step(config: Config, batch_cols: int, device=None, slab_cols: int = 0,
                      slab_head: int = 0):
    """The multi-sensor step on ``device`` (the card unless the caller names
    another): ``run(state, batch, calib) -> (state, StepInfo)`` with a
    stacked state (``stacked_init``), a ``FiringBatch`` and an
    ``EgoCalibration`` whose leaves carry the leading sensor axis.  The
    state is updated in place; every ``StepInfo`` leaf carries the sensor
    axis.  ``slab_cols``/``slab_head`` add the publish slab, as
    ``pipeline_step`` takes them."""
    dev = torch.device("cuda" if device is None else device)

    def run(state: RingState, batch: FiringBatch, calib: EgoCalibration):
        if state.x.device.type != dev.type:
            raise ValueError(f"the state is on {state.x.device}, the step on {dev}")
        batch = FiringBatch(*[t.to(dev) for t in batch])
        calib = EgoCalibration(*[t.to(dev) for t in calib])
        n_sensors = state.x.shape[0]
        views = [stream_state(state, s) for s in range(n_sensors)]
        bound = [{n: getattr(v, n) for n in FIELDS} for v in views]
        pre = [insert_and_segment(config, views[s], _pick(batch, s), _pick(calib, s), batch_cols)
               for s in range(n_sensors)]
        counters = [st.cluster_counter for st, _, _ in pre]
        wins = [window_arrays(config, st, gcol0, n_cols, batch_cols) for st, gcol0, n_cols in pre]
        ccs = window_kernels(config, wins)
        infos = []
        for s, ((st, gcol0, n_cols), win, cc) in enumerate(zip(pre, wins, ccs)):
            cres = complete_association(config, st, gcol0, n_cols, batch_cols, win, cc)
            st, info = finish_step(config, cres, gcol0, n_cols, counters[s], slab_cols,
                                   slab_head)
            for n, t0 in bound[s].items():
                t = getattr(st, n)
                if t is not t0:
                    getattr(state, n)[s].copy_(t)
            infos.append(info)
        return state, StepInfo(*[torch.stack(xs) for xs in zip(*infos)])

    return run
