"""The sensor entry point from raw packets on the card against the same
packets through the same preset on the CPU.

Marked ``cuda``: skips without a CUDA device.  Imports nothing of JAX or of
the JAX package, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_node_card.py

The packets come from ``tools/sensor_packets.py``: ray-cast scenes of 2
revolutions at the decoders' beam inclinations.  The nodes are
``launch.make_node`` of the reference's ``demo_touareg`` presets, each with
its decode thread and asynchronous consumption: the roof VLS-128 at 340
columns and at its full 1,700, and both OS-32 presets (32 x 1024, fog
filtering on, their ``sensor_info`` written to a file).  Tolerance: the
published partition (agreement 1.0 on the same points), the clusters' sizes
and stamps, exact; K1, K2 and the ground segmentation kernel must have been
launched.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _run(desc, packets, device):
    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp

    node = launch.make_node(desc, firing_batch_size=128, device=device)
    labels, clusters = {}, []

    def on_instance(cloud):
        ok = np.isfinite(cloud["x"])
        labels.update(zip(zip(cloud["global_column_index"][ok].tolist(),
                              cloud["row_index"][ok].tolist()), cloud["id"][ok].tolist()))

    node.publish_instance_columns = on_instance
    node.publish_cluster = lambda pts, stamp: clusters.append((len(pts), int(stamp)))
    sp.feed(node, packets)
    assert node.sensor_input.pending_packets() == 0
    assert not desc.config.general.is_single_threaded and node.sensor_input._offload is not None
    return labels, clusters


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the node's kernels run only on the card")


def _card_equals_cpu(desc, packets):
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    labels, clusters = _run(desc, packets, "cuda")
    assert all(LAUNCHES[k] > 0 for k in ("edge_bits", "window_cc", "ground_segment")), LAUNCHES
    cpu_labels, cpu_clusters = _run(desc, packets, "cpu")
    assert len(cpu_labels) > 5000 and labels.keys() == cpu_labels.keys()
    assert partition_agreement(cpu_labels, labels) == 1.0
    assert clusters == cpu_clusters and clusters


@pytest.mark.parametrize("columns", [340, 1700])
def test_vls128_node_on_the_card_equals_the_cpu(columns):
    _card()
    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp

    desc = launch.sensor_vls128_roof()
    desc.config = desc.config.replace(range_image=dataclasses.replace(
        desc.config.range_image, num_columns=columns))
    frames = sp.scene_frames(128, columns, 2, sp.velodyne_inclinations(128), seed=7,
                             num_boxes=10 if columns == 340 else 16,
                             spread=15.0 if columns == 340 else 30.0)
    _card_equals_cpu(desc, sp.velodyne_packets(frames))


@pytest.mark.parametrize("position", ["left", "right"])
def test_os32_node_on_the_card_equals_the_cpu(position, tmp_path):
    _card()
    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp

    info = sp.os32_sensor_info()
    meta = tmp_path / "os32_sensor_info.json"
    meta.write_text(json.dumps(info))
    desc = launch.sensor_os32(position, metadata_path=str(meta))
    assert desc.config.ground_segmentation.fog_filtering_enabled
    assert desc.config.range_image.num_columns == info["data_format"]["columns_per_frame"] == 1024
    rows = info["data_format"]["pixels_per_column"]
    frames = sp.scene_frames(rows, 1024, 2, np.deg2rad(np.asarray(info["beam_altitude_angles"])),
                             seed=9 if position == "left" else 10, num_boxes=12, spread=20.0)
    _card_equals_cpu(desc, sp.ouster_legacy_packets(frames, info))
