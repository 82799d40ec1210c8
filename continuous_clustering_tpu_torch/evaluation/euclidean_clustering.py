"""Ground-truth label generation by conditional euclidean clustering (the
port's copy of ``continuous_clustering_tpu/evaluation/euclidean_clustering.py``;
host-side NumPy, no device work).

Replaces the reference's PCL ConditionalEuclideanClustering
(``src/evaluation/kitti_evaluation.cpp:224-275``): points cluster together
when within ``MAX_DISTANCE`` *and* sharing semantic and instance labels;
clusters outside [MIN_CLUSTER_SIZE, MAX_CLUSTER_SIZE] are dropped; points
with ground/unlabeled semantics get label 0.

Implemented as a uniform-grid hash + union-find: exact same partition as
PCL's radius-search region growing (the pairwise condition is symmetric).
"""

from __future__ import annotations

import numpy as np

from .kitti_loader import GROUND_LABEL_IDS, UNLABELED_ID

# From https://github.com/url-kaist/TRAVEL/issues/6 via the reference
# (evaluation/kitti_evaluation.hpp:51-57)
MAX_DISTANCE = 1.0
MIN_CLUSTER_SIZE = 10
MAX_CLUSTER_SIZE = 300000


def _union_find_pairs(n: int, pairs_a: np.ndarray, pairs_b: np.ndarray) -> np.ndarray:
    """Vectorized-ish union-find over an edge list; returns root labels."""
    parent = np.arange(n, dtype=np.int64)

    def find_many(idx):
        # path-halving resolution until fixpoint
        idx = parent[idx]
        while True:
            nxt = parent[idx]
            if np.array_equal(nxt, idx):
                return idx
            idx = nxt

    # iterate hooking until no change (edges are local, few rounds needed)
    for _ in range(64):
        ra = find_many(pairs_a)
        rb = find_many(pairs_b)
        lo = np.minimum(ra, rb)
        hi = np.maximum(ra, rb)
        mask = lo != hi
        if not mask.any():
            break
        np.minimum.at(parent, hi[mask], lo[mask])
        # compress
        parent = parent[parent]
        parent = parent[parent]
    # final resolve
    while True:
        nxt = parent[parent]
        if np.array_equal(nxt, parent):
            break
        parent = nxt
    return parent


def generate_euclidean_clustering_labels(
    xyz: np.ndarray, semantic: np.ndarray, instance: np.ndarray
) -> np.ndarray:
    """Returns uint16 labels (0 = none), one per point."""
    n_all = len(xyz)
    if n_all == 0:
        return np.zeros(0, dtype=np.uint16)

    # ground/unlabeled points get label 0 regardless (…cpp:256-262) and the
    # same-label condition isolates them from everything else, so skip
    # clustering them entirely (the dominant point mass)
    keep = ~(np.isin(semantic, list(GROUND_LABEL_IDS)) | (semantic == UNLABELED_ID))
    if not keep.any():
        return np.zeros(n_all, dtype=np.uint16)
    keep_idx = np.flatnonzero(keep)
    xyz = np.ascontiguousarray(xyz[keep])
    semantic = semantic[keep]
    instance = instance[keep]
    n = len(xyz)

    cell = np.floor(xyz / MAX_DISTANCE).astype(np.int64)
    # hash cells together with the condition labels so only same-label
    # neighborhoods generate candidate pairs (hash collisions just add
    # candidates; the exact distance+label filter below keeps it sound)
    key_base = (
        semantic.astype(np.int64) * 1_000_003 + instance.astype(np.int64)
    ) * 1_000_000_007

    def cell_key(c):
        return key_base ^ (c[:, 0] * 73856093) ^ (c[:, 1] * 19349663) ^ (
            c[:, 2] * 83492791
        )

    k0 = cell_key(cell)
    sort_idx = np.argsort(k0, kind="stable")
    k_sorted = k0[sort_idx]

    def pairs_for_key(k1):
        """All (point, sorted-point) pairs with matching keys, vectorized."""
        lo = np.searchsorted(k_sorted, k1, side="left")
        hi = np.searchsorted(k_sorted, k1, side="right")
        lens = hi - lo
        total = int(lens.sum())
        if total == 0:
            return None, None
        pa = np.repeat(np.arange(n), lens)
        cum = np.concatenate([[0], np.cumsum(lens)])
        within = np.arange(total) - np.repeat(cum[:-1], lens)
        pb = sort_idx[np.repeat(lo, lens) + within]
        return pa, pb

    # half-space of the 27 neighbor offsets + same cell (a<b dedupe)
    half = [
        o
        for o in (
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        )
        if o > (0, 0, 0)
    ]
    pair_a, pair_b = [], []
    pa, pb = pairs_for_key(k0)  # same cell (and hash-colliding cells)
    if pa is not None:
        keep = pa < pb
        pair_a.append(pa[keep])
        pair_b.append(pb[keep])
    for off in half:
        pa, pb = pairs_for_key(cell_key(cell + np.array(off, dtype=np.int64)))
        if pa is not None:
            pair_a.append(pa)
            pair_b.append(pb)

    if pair_a:
        pa = np.concatenate(pair_a)
        pb = np.concatenate(pair_b)
        d2 = np.sum((xyz[pa] - xyz[pb]) ** 2, axis=1)
        same = (semantic[pa] == semantic[pb]) & (instance[pa] == instance[pb])
        keep = (d2 < MAX_DISTANCE * MAX_DISTANCE) & same
        roots = _union_find_pairs(n, pa[keep], pb[keep])
    else:
        roots = np.arange(n, dtype=np.int64)

    # cluster sizes + ordering by first occurrence (PCL discovery order is by
    # point index; label VALUES are irrelevant to the entropy metrics)
    uniq, inverse, counts = np.unique(roots, return_inverse=True, return_counts=True)
    ok = (counts >= MIN_CLUSTER_SIZE) & (counts <= MAX_CLUSTER_SIZE)

    labels = np.zeros(n, dtype=np.uint16)
    # assign 1..k in order of first point occurrence
    first_idx = np.full(len(uniq), n, dtype=np.int64)
    np.minimum.at(first_idx, inverse, np.arange(n))
    order = np.argsort(first_idx, kind="stable")
    next_label = 1
    remap = np.zeros(len(uniq), dtype=np.uint16)
    for u in order:
        if ok[u]:
            remap[u] = next_label
            next_label += 1
    labels = remap[inverse]

    out = np.zeros(n_all, dtype=np.uint16)
    out[keep_idx] = labels
    return out
