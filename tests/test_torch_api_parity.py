"""Public API details of the port's facade against the JAX package's answers,
on the CPU: the port's counterparts of ``tests/test_api_parity.py`` (stage
field subsets, the ``reset_required_vs`` rules, ``set_configuration``
flagging a reset, the stage subset of ``get_columns``) and of
``tests/test_rebase.py::test_slab_invalidated_on_rebase_{sync,async}``
(continuous azimuths read right after a rebase).

Tolerance: names, counts, flags and integer fields exactly; the
``get_columns`` points' f32 coordinates exactly (both facades publish the
stored ring values); the azimuths read after a rebase within the JAX
test's 1.0 rad of their column's absolute azimuth, within ``ATAN2_ULPS``
(1) f32 ulp at each point's absolute azimuth of the JAX facade's reads of
the same points on the same firings (XLA's f32 ``arctan2`` in the JAX
insertion is up to 1 ulp from the once-rounded f64 one the port uses,
``continuous_clustering_tpu_torch/ops/insertion.py``; the continuous
azimuth carries that ulp, and a rebase subtracts whole turns exactly), and
within 1e-4 rad of the same points read in a run that never rebases.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest

from continuous_clustering_tpu.config import Config as JaxConfig
from continuous_clustering_tpu.io import point_cloud as jax_point_cloud
from continuous_clustering_tpu.models.continuous_clustering import (
    ContinuousClustering as JaxContinuousClustering)
from continuous_clustering_tpu_torch.config import Config
from continuous_clustering_tpu_torch.convert import config_from_dataclass
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)
from continuous_clustering_tpu_torch.io.point_cloud import (POINT_DTYPE, ProcessingStage,
                                                            stage_dtype)
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

from .test_pipeline import small_config
from .test_torch_step import one_torch_thread  # noqa: F401

ATAN2_ULPS = 1


@pytest.fixture
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the port's native insertion library")


def test_stage_field_subsets():
    """8/15/19/26 fields per stage (reference ros_utils.cpp:114-122), the
    JAX package's names and types in its order."""
    counts = {}
    for stage in ProcessingStage:
        jstage = jax_point_cloud.ProcessingStage(stage.value)
        assert stage.name == jstage.name
        assert stage_dtype(stage) == jax_point_cloud.stage_dtype(jstage)
        counts[stage.name] = len(stage_dtype(stage).names)
    assert counts == {"RAW_POINT": 8, "RANGE_IMAGE_GENERATION": 15,
                      "GROUND_POINT_SEGMENTATION": 19, "CONTINUOUS_CLUSTERING": 26}
    assert POINT_DTYPE == jax_point_cloud.POINT_DTYPE
    assert POINT_DTYPE.names[:3] == ("x", "y", "z")


def _changes(cfg):
    """Configurations that differ from ``cfg`` in one setting each (the
    cases of tests/test_api_parity.py, and one per reset-relevant group)."""
    return {
        "same": cfg,
        "num_columns": cfg.replace(range_image=cfg.range_image.__class__(num_columns=999)),
        "single_threaded": cfg.replace(
            general=dataclasses.replace(cfg.general, is_single_threaded=True)),
        "max_distance": cfg.replace(
            clustering=dataclasses.replace(cfg.clustering, max_distance=0.3)),
        "ring_revolutions": cfg.replace(range_image=dataclasses.replace(
            cfg.range_image, ring_buffer_revolutions=cfg.range_image.ring_buffer_revolutions + 1)),
        "max_steps_in_row": cfg.replace(clustering=dataclasses.replace(
            cfg.clustering, max_steps_in_row=cfg.clustering.max_steps_in_row + 1)),
    }


def test_config_reset_required_rules():
    """Hard-reset rules (reference setConfiguration, …cpp:66-81): the port's
    answer equals the JAX package's for each change."""
    jbase, base = JaxConfig(), Config()
    jans = {k: jbase.reset_required_vs(c) for k, c in _changes(jbase).items()}
    ans = {k: base.reset_required_vs(c) for k, c in _changes(base).items()}
    assert ans == jans
    assert ans["num_columns"] and ans["single_threaded"]
    assert not ans["same"] and not ans["max_distance"]   # live-tunable without reset
    for k, c in _changes(jbase).items():
        assert base.reset_required_vs(config_from_dataclass(c)) == jans[k], k


def test_set_configuration_flags_reset(needs_gxx):
    jcfg = small_config()
    pipe = ContinuousClustering(config_from_dataclass(jcfg), firing_batch_size=32, device="cpu")
    pipe.reset(16)
    assert not pipe.reset_required()
    pipe.set_configuration(config_from_dataclass(jcfg.replace(
        range_image=jcfg.range_image.__class__(num_columns=220 * 2))))
    assert pipe.reset_required()
    # a live-tunable change flags nothing
    pipe = ContinuousClustering(config_from_dataclass(jcfg), firing_batch_size=32, device="cpu")
    pipe.reset(16)
    pipe.set_configuration(config_from_dataclass(jcfg.replace(
        clustering=dataclasses.replace(jcfg.clustering, max_distance=0.3))))
    assert not pipe.reset_required()


def test_get_columns_stage_subset(needs_gxx):
    """The ground-stage and full clouds of columns 10-20: the JAX facade's
    fields, length and column-major layout, and the same points."""
    jcfg = small_config()
    xyz, _ = raycast_frame(make_scene(num_boxes=2, seed=0), num_rows=16, num_columns=220)
    clouds = []
    for pipe, stage in ((ContinuousClustering(config_from_dataclass(jcfg), firing_batch_size=32,
                                              device="cpu"),
                         ProcessingStage.GROUND_POINT_SEGMENTATION),
                        (JaxContinuousClustering(jcfg, firing_batch_size=32),
                         jax_point_cloud.ProcessingStage.GROUND_POINT_SEGMENTATION)):
        pipe.reset(16)
        pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
        for f in frame_to_firings(xyz):
            pipe.add_firing(f, np.eye(4))
        pipe.flush()
        clouds.append((pipe.get_columns(10, 20, stage), pipe.get_columns(10, 20)))
    (ground, full), (jground, jfull) = clouds
    assert ground.dtype == jground.dtype and len(ground.dtype.names) == 19
    assert "ground_point_label" in ground.dtype.names and "id" not in ground.dtype.names
    assert full.dtype == jfull.dtype and "id" in full.dtype.names
    # column-major like the reference message (16 rows x 11 columns)
    assert len(full) == len(ground) == len(jfull) == 16 * 11
    for name in ("x", "y", "z", "global_column_index", "row_index", "ground_point_label",
                 "globally_unique_point_index"):
        np.testing.assert_array_equal(ground[name], jground[name], err_msg=name)


NUM_ROWS, NUM_COLS = 16, 110


def _rebase_run(single_threaded: bool, rebase_after: int, facade: str = "port"):
    """tests/test_rebase.py::_run_checking_slab_reads on the port's facade
    (or, with ``facade="jax"``, the JAX package's): 8 revolutions, reading
    the freshest published columns right after each rebase.  Returns
    {uidx: azimuth} of those reads (with no rebase: of every published
    column), and the rebases seen."""
    cfg = small_config()
    cfg = cfg.replace(
        range_image=cfg.range_image.__class__(num_columns=NUM_COLS, ring_buffer_revolutions=4),
        general=dataclasses.replace(cfg.general, is_single_threaded=single_threaded))
    if facade == "jax":
        pipe = JaxContinuousClustering(cfg, firing_batch_size=55,
                                       rebase_after_rotations=rebase_after)
    else:
        pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=55,
                                    rebase_after_rotations=rebase_after, device="cpu")
    pipe.reset(NUM_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    scene = make_scene(num_boxes=5, seed=4, spread=15.0)
    xyz, _ = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS, seed=4)
    col_w = 2 * np.pi / NUM_COLS
    azimuths, rebases, uidx_base = {}, 0, 0

    def keep(cloud):
        valid = (cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max) & np.isfinite(
            cloud["continuous_azimuth_angle"])
        azimuths.update(zip(cloud["globally_unique_point_index"][valid].tolist(),
                            cloud["continuous_azimuth_angle"][valid].tolist()))

    if rebase_after > 8:
        pipe.set_finished_column_callback(
            lambda a, b, ground_only: ground_only or keep(pipe.get_columns(a, b)))
    for rev in range(8):
        firings = frame_to_firings(xyz, frame_index=rev)
        for f in firings:
            f["uidx"] = f["uidx"] + np.uint64(uidx_base)
        uidx_base += NUM_COLS * NUM_ROWS * 2
        for f in firings:
            origin = pipe._h_origin_rot
            pipe.add_firing(f, np.eye(4))
            if pipe._h_origin_rot == origin:
                continue
            rebases += 1
            # the freshest published columns, read right after the rebase
            fu = pipe.first_unpublished_global_column_index
            if fu >= 5:
                cloud = pipe.get_columns(fu - 5, fu - 1)
                az = cloud["continuous_azimuth_angle"]
                if np.any(np.isfinite(az)):
                    med = float(np.nanmedian(az))
                    assert abs(med - (fu - 3) * col_w) < 1.0, (
                        f"stale publish slab after rebase: median azimuth {med}, "
                        f"expected {(fu - 3) * col_w}")
                keep(cloud)
    pipe.flush()
    return azimuths, rebases


@pytest.mark.parametrize("single_threaded", [True, False], ids=["sync", "async"])
def test_slab_invalidated_on_rebase(needs_gxx, single_threaded):
    """A publish slab cached (or in flight) before a rebase is not served
    with the new azimuth origin afterwards; the azimuths read right after
    each rebase are the JAX facade's reads of the same points on the same
    firings, and those a run without rebases publishes."""
    after, rebases = _rebase_run(single_threaded, rebase_after=2)
    assert rebases >= 1, "rebase never triggered"
    jafter, jrebases = _rebase_run(single_threaded, rebase_after=2, facade="jax")
    assert rebases == jrebases and set(after) == set(jafter)
    port_az = np.array([after[u] for u in sorted(after)])
    jax_az = np.array([jafter[u] for u in sorted(after)])
    ulps = np.abs(port_az - jax_az) / np.spacing(np.abs(port_az).astype(np.float32))
    assert ulps.max() <= ATAN2_ULPS, f"differs from the JAX facade's by {ulps.max()} ulp"
    plain, none = _rebase_run(single_threaded, rebase_after=10_000)
    assert none == 0 and after and set(after) <= set(plain)
    worst = max(abs(az - plain[u]) for u, az in after.items())
    assert worst < 1e-4, worst
