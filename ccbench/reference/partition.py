# FROZEN COPY of ``continuous_clustering_tpu_torch/evaluation/partition.py`` at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file, so the benchmark measures every commit with the same
# code.  Only imports were changed, so that nothing here imports the
# program or the JAX package.  The original's docstring follows.

"""Cluster partition comparison utilities.

Used to measure label agreement between two clusterings of the same points
(e.g. the streaming pipeline vs the sequential oracle / C++ reference), where
cluster *ids* are arbitrary but the partition should match.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def partition_agreement(a: Dict[int, int], b: Dict[int, int]) -> float:
    """Fraction of common points on which the two partitions agree.

    Points labeled 0 are "unclustered" and must map to 0 on the other side to
    agree.  Nonzero labels are matched greedily by overlap (majority vote per
    cluster, both directions); a point agrees when its pair (la, lb) is the
    mutual best match for both labels.
    """
    common = sorted(set(a) & set(b))
    if not common:
        return 1.0
    la = np.array([a[k] for k in common], dtype=np.int64)
    lb = np.array([b[k] for k in common], dtype=np.int64)

    both_zero = (la == 0) & (lb == 0)
    nz = (la != 0) & (lb != 0)
    mixed = ~both_zero & ~nz  # one side clustered, other not -> disagree

    # contingency over nonzero pairs
    pairs, counts = np.unique(np.stack([la[nz], lb[nz]]), axis=1, return_counts=True)
    pa, pb = pairs
    best_a: Dict[int, Tuple[int, int]] = {}
    best_b: Dict[int, Tuple[int, int]] = {}
    for x, y, c in zip(pa, pb, counts):
        if x not in best_a or c > best_a[x][1]:
            best_a[x] = (y, c)
        if y not in best_b or c > best_b[y][1]:
            best_b[y] = (x, c)
    agree = both_zero.sum()
    for x, y, c in zip(pa, pb, counts):
        if best_a[x][0] == y and best_b[y][0] == x:
            agree += c
    return float(agree) / float(len(common))
