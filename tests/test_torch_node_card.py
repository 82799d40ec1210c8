"""The VLS-128 roof preset from raw packets on the card against the same
packets through the same preset on the CPU.

Marked ``cuda``: skips without a CUDA device.  Imports nothing of JAX or of
the JAX package, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_node_card.py

The packets come from ``tools/sensor_packets.py`` (a ray-cast scene at the
decoder's 128 default inclinations, 340 columns, 2 revolutions); the node is
``launch.make_node(launch.sensor_vls128_roof())`` at 340 columns, with its
decode thread and asynchronous consumption.  Tolerance: the published
partition (agreement 1.0 on the same points), the clusters' sizes and
stamps, exact; K1 and K2 must have been launched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

COLUMNS = 340


def _run(device):
    from continuous_clustering_tpu_torch import launch
    from continuous_clustering_tpu_torch.tools import sensor_packets as sp

    desc = launch.sensor_vls128_roof()
    desc.config = desc.config.replace(range_image=dataclasses.replace(
        desc.config.range_image, num_columns=COLUMNS))
    node = launch.make_node(desc, firing_batch_size=128, device=device)
    labels, clusters = {}, []

    def on_instance(cloud):
        ok = np.isfinite(cloud["x"])
        labels.update(zip(zip(cloud["global_column_index"][ok].tolist(),
                              cloud["row_index"][ok].tolist()), cloud["id"][ok].tolist()))

    node.publish_instance_columns = on_instance
    node.publish_cluster = lambda pts, stamp: clusters.append((len(pts), int(stamp)))
    frames = sp.scene_frames(128, COLUMNS, 2, sp.velodyne_inclinations(128), seed=7,
                             num_boxes=10, spread=15.0)
    sp.feed(node, sp.velodyne_packets(frames))
    assert node.sensor_input.pending_packets() == 0
    return labels, clusters


def test_vls128_node_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the node's kernels run only on the card")
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.ops import cc_cuda

    cc_cuda.reset_launch_counts()
    labels, clusters = _run("cuda")
    assert cc_cuda.LAUNCHES["edge_bits"] > 0 and cc_cuda.LAUNCHES["window_cc"] > 0
    cpu_labels, cpu_clusters = _run("cpu")
    assert len(cpu_labels) > 5000 and labels.keys() == cpu_labels.keys()
    assert partition_agreement(cpu_labels, labels) == 1.0
    assert clusters == cpu_clusters and clusters
