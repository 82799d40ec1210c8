"""The comparison that decides ``correct``: the program agrees with the
reference on a small stream on the CPU, and comes out not correct when
its timed path is broken underneath (the run otherwise as the benchmark
drives it) and when the control, the reference with its points in
bfloat16, takes the program's place."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccbench import harness
from ccbench.check import compare, judge, steady_as_output
from ccbench.drivers import facade, node
from ccbench.reference.steady import round_to_bfloat16, steady_revolution
from ccbench.tests.small import SEED, run_small, small_cell

import continuous_clustering_tpu_torch.models.continuous_clustering as cc_mod
from continuous_clustering_tpu_torch.io import native_readout
from continuous_clustering_tpu_torch.ops.state import copy_state

CELLS = ["kitti_hdl64.standard.host", "kitti_hdl64.standard.device",
         "kitti_hdl64.standard.paced", "touareg_vls128.packets.node"]
PACED = {"columns_per_s": 2000.0}


def _run(cell, **kw):
    return run_small(cell, **(PACED if cell.endswith("paced") else {}), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell):
    # long enough for whole revolutions on a slow, shared CPU
    out = _run(cell, seconds=6.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged_state(real):
    # the step updates the ring in place: hand back a copy taken before it
    def step(config, state, *args, **kw):
        before = copy_state(state)
        return before, real(config, state, *args, **kw)[1]
    return step


@pytest.mark.parametrize("cell", ["kitti_hdl64.standard.host", "kitti_hdl64.standard.device"])
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(cc_mod, "pipeline_step_block", _unchanged_state(cc_mod.pipeline_step_block))
    monkeypatch.setattr(cc_mod, "pipeline_step", _unchanged_state(cc_mod.pipeline_step))
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_batch_left_out_is_not_correct(cell, monkeypatch):
    real = cc_mod.ContinuousClustering._process_batch

    def half(self):
        self._fifo = self._fifo[::2]
        self._fifo_poses = self._fifo_poses[::2]
        real(self)

    monkeypatch.setattr(cc_mod.ContinuousClustering, "_process_batch", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    real = native_readout.emit_clusters

    def altered(*args, **kw):
        groups, full = real(*args, **kw)
        return [(g, s + 1) for g, s in groups], full

    monkeypatch.setattr(native_readout, "emit_clusters", altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["cluster_disagreement"]["value"] > out["checks"]["cluster_disagreement"]["limit"]


@pytest.mark.parametrize("cell", ["kitti_hdl64.standard.host", "touareg_vls128.packets.node"])
def test_the_control_is_not_correct(cell):
    c = small_cell(cell)
    mod = node if c.traffic["driver"] == "node" else facade
    d = mod.Driver(None, c.config, c.traffic, SEED, torch.device("cpu"))
    R = c.config["sensor"]["rows"]
    ref = steady_revolution(c.config["pipeline"], R, d.reference_firing, d.ego)
    ctl = steady_revolution(c.config["pipeline"], R, d.reference_firing, d.ego,
                            bfloat16_points=True)
    clusters, cols = steady_as_output(ctl)
    res = compare(ref, clusters, cols, [1], d.rev_ns, d.uidx_per_rev)
    assert not judge(res["numbers"], c.limits), res["numbers"]
    clusters, cols = steady_as_output(ref)
    same = compare(ref, clusters, cols, [1], d.rev_ns, d.uidx_per_rev)
    assert judge(same["numbers"], c.limits), same["numbers"]


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.01171875, -3.14159, np.nan], np.float32)
    y = round_to_bfloat16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.015625   # ties to even, then up
    assert abs(y[3] + 3.140625) < 1e-6 and np.isnan(y[4])
    assert harness.load_cell(CELLS[0]).limits
