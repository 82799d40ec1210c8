"""Checkpoint / resume of the port's facade, and the file exchange with the
JAX package's ``models/checkpoint.py``, on the CPU.

* The port's own resume: half a stream, ``save_state``, ``load_state`` into
  a fresh facade, the rest of the stream; partition agreement with the
  uninterrupted run >= 0.99 (the JAX test's bound,
  ``tests/test_checkpoint.py``).  The first half runs on host insertion, the
  resume on device insertion, as in the JAX package.
* A file the JAX package wrote, resumed in the port, publishes exactly the
  labels (point -> cluster id) and clusters that the JAX package's own
  resume from the same file publishes; and the reverse, a file the port
  wrote resumed in the JAX package.  Both resumes run device insertion.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from continuous_clustering_tpu.models.checkpoint import load_state as jax_load
from continuous_clustering_tpu.models.checkpoint import save_state as jax_save
from continuous_clustering_tpu.models.continuous_clustering import (
    ContinuousClustering as JaxContinuousClustering)
from continuous_clustering_tpu_torch.convert import config_from_dataclass
from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
from continuous_clustering_tpu_torch.models.checkpoint import load_state, save_state
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

from .test_pipeline import make_stream, small_config
from .test_torch_step import one_torch_thread  # noqa: F401

BATCH = 55


def port_pipe(cfg, insertion="device"):
    p = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=BATCH,
                             device="cpu", insertion=insertion)
    p.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    return p


def jax_pipe(cfg):
    p = JaxContinuousClustering(cfg, firing_batch_size=BATCH)
    p.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    return p


def run(pipe, firings, poses, labels, clusters=None):
    def on_col(a, b, ground_only):
        if ground_only:
            return
        cloud = pipe.get_columns(a, b)
        valid = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        for u, i in zip(cloud["globally_unique_point_index"][valid], cloud["id"][valid]):
            labels[int(u)] = int(i)

    pipe.set_finished_column_callback(on_col)
    if clusters is not None:
        pipe.set_finished_cluster_callback(
            lambda pts, stamp: clusters.append((len(pts), stamp)))
    for f, p in zip(firings, poses):
        pipe.add_firing(f, p)


def test_port_checkpoint_resume(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    cfg = small_config()
    firings, poses = make_stream(num_frames=2, seed=9)
    half = len(firings) // 2

    ref = {}
    pipe = port_pipe(cfg, "host")
    pipe.reset(32)
    run(pipe, firings, poses, ref)
    pipe.flush()

    labels = {}
    p1 = port_pipe(cfg, "host")
    p1.reset(32)
    run(p1, firings[:half], poses[:half], labels)
    ckpt = tmp_path / "state.npz"
    save_state(p1, ckpt)
    p2 = port_pipe(cfg, "host")
    load_state(p2, ckpt)
    assert p2._host_ins is None
    assert p2._h_cluster_counter == p1._h_cluster_counter > 1
    run(p2, firings[half:], poses[half:], labels)
    p2.flush()

    common = set(ref) & set(labels)
    assert len(common) > 0.9 * len(ref)
    agreement = partition_agreement(ref, labels)
    assert agreement >= 0.99, f"resume agreement {agreement}"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_exchange_with_jax(tmp_path, monkeypatch, writer):
    monkeypatch.setenv("CCT_HOST_INSERT", "0")
    cfg = small_config()
    firings, poses = make_stream(num_frames=2, seed=9)
    half = len(firings) // 2
    ckpt = tmp_path / "state.npz"
    first = jax_pipe(cfg) if writer == "jax" else port_pipe(cfg)
    first.reset(32)
    run(first, firings[:half], poses[:half], {})
    (jax_save if writer == "jax" else save_state)(first, ckpt)

    results = []
    for resume, load in ((jax_pipe(cfg), jax_load), (port_pipe(cfg), load_state)):
        load(resume, ckpt)
        assert resume._host_ins is None
        labels, clusters = {}, []
        run(resume, firings[half:], poses[half:], labels, clusters)
        resume.flush()
        results.append((labels, clusters, resume._h_cluster_counter,
                        resume.first_unpublished_global_column_index))
    (j_labels, j_clusters, j_counter, j_fu), (t_labels, t_clusters, t_counter, t_fu) = results
    assert len(t_labels) > 1000 and t_clusters
    assert t_labels == j_labels
    assert t_clusters == j_clusters
    assert (t_counter, t_fu) == (j_counter, j_fu)
