"""The comparison that decides ``correct``: what the program published in a
run against the reference's steady revolution (``reference/steady.py``).

The program's answers, in plain arrays:

* ``Clusters``: every cluster its finished-cluster callback published,
  each as the global column and row of its points, their coordinates, and
  the cluster's stamp;
* ``Columns``: its last published revolution, read back once the stream
  was flushed: per cell the global column, row, whether a point is there,
  its coordinates, ground label, stamp and point index (-1 where the
  stream has none).

Numbers compared, each against the cell's limit (``limits/<cell>.json``):

* ``cluster_disagreement``: over every revolution k >= 1 whose clusters the
  stream finished, the share of the points of the program's and the
  reference's clusters on which the two partitions disagree (the mutual
  best match of ``reference/partition.py``), the points of a cluster
  published with another stamp than the reference's counted as
  disagreeing; 1 where no revolution could be compared;
* ``point_mismatch``: of the cells of the last published revolution that
  hold a point on either side, the share where the program has none and
  the reference one, or the other way round, or another stamp or point
  index (insertion);
* ``ground_mismatch``: of the points both have there, the share with
  another ground label;
* ``xyz_error_m``: the largest coordinate difference of any compared point
  (the decoder, where the input is packets).

``attempted`` counts the reference's clusters due in the compared
revolutions, ``failed`` those the program did not publish with the same
points and stamp.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .reference.partition import partition_agreement
from .reference.steady import SteadyRevolution


@dataclasses.dataclass
class Cluster:
    gcol: np.ndarray      # (n,) i64
    row: np.ndarray       # (n,) i64
    xyz: np.ndarray       # (n, 3) f32
    stamp: int


@dataclasses.dataclass
class Columns:
    gcol: np.ndarray      # (m,) i64
    row: np.ndarray       # (m,) i64
    present: np.ndarray   # (m,) bool
    xyz: np.ndarray       # (m, 3) f32
    ground: np.ndarray    # (m,) u8
    stamp: np.ndarray     # (m,) u64
    uidx: np.ndarray      # (m,) i64, -1 where the stream numbers no points


def _max_abs(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def compare(ref: SteadyRevolution, clusters: Sequence[Cluster], cols: Columns,
            revolutions: Sequence[int], rev_ns: int, uidx_per_rev: int) -> Dict:
    """The numbers above, ``attempted`` and ``failed``, for the program's
    clusters of ``revolutions`` and its columns ``cols``."""
    C, R = ref.num_columns, ref.num_rows
    out: Dict = {}

    # -- points of the last published revolution (insertion, ground, decode)
    keep = cols.gcol >= C
    g, r = cols.gcol[keep], cols.row[keep]
    k, c = g // C, g % C
    p_here = cols.present[keep]
    r_here = ref.present[c, r]
    both = p_here & r_here
    stamp_ref = ref.stamp[c, r] + ((k - 1) * rev_ns).astype(np.uint64)
    bad_stamp = both & (cols.stamp[keep] != stamp_ref)
    uidx_ref = np.where(ref.uidx[c, r] >= 0, ref.uidx[c, r] + (k - 1) * uidx_per_rev, -1)
    bad_uidx = both & (cols.uidx[keep] != uidx_ref)
    n_any = int((p_here | r_here).sum())
    bad_points = int(((p_here != r_here) | bad_stamp | bad_uidx).sum())
    out["point_mismatch"] = bad_points / n_any if n_any else 1.0
    n_both = int(both.sum())
    bad_ground = int((both & (cols.ground[keep] != ref.ground[c, r])).sum())
    out["ground_mismatch"] = bad_ground / n_both if n_both else 1.0
    xyz_err = _max_abs(cols.xyz[keep][both], ref.xyz[c, r][both])

    # -- clusters of every finished revolution (association, readout, emission)
    by_rev: Dict[int, List[Cluster]] = {}
    wanted = set(revolutions)
    for cl in clusters:
        kmin = int(cl.gcol.min()) // C
        if kmin in wanted:
            by_rev.setdefault(kmin, []).append(cl)
    ref_keys = {cl.tobytes(): (j, st) for j, (cl, st) in
                enumerate(zip(ref.clusters, ref.cluster_stamps))}
    ref_label = {int(key): j + 1 for j, cl in enumerate(ref.clusters) for key in cl}
    agree = total = 0.0
    attempted = failed = 0
    for kk in revolutions:
        port_label = {}
        matched = set()
        wrong_stamp = 0
        for i, cl in enumerate(by_rev.get(kk, [])):
            keys = np.sort((cl.gcol - kk * C) * R + cl.row)
            for key in keys:
                port_label[int(key)] = i + 1
            hit = ref_keys.get(keys.tobytes())
            if hit is None:
                continue
            j, st = hit
            if cl.stamp == st + (kk - 1) * rev_ns:
                matched.add(j)
            else:
                # the right points under the wrong stamp disagree all the same
                wrong_stamp += len(keys)
            rk = keys % (C * R)
            xyz_err = max(xyz_err, _max_abs(cl.xyz[np.argsort((cl.gcol - kk * C) * R + cl.row)],
                                            ref.xyz[rk // R, rk % R]))
        union = set(port_label) | set(ref_label)
        a = {key: port_label.get(key, 0) for key in union}
        b = {key: ref_label.get(key, 0) for key in union}
        agree += partition_agreement(a, b) * len(union) - wrong_stamp
        total += len(union)
        attempted += len(ref.clusters)
        failed += len(ref.clusters) - len(matched)
    out["cluster_disagreement"] = 1.0 - agree / total if total else 1.0
    out["xyz_error_m"] = xyz_err
    return {"numbers": out, "attempted": attempted, "failed": failed,
            "revolutions": list(revolutions)}


def steady_as_output(ref: SteadyRevolution):
    """A steady revolution as a program's answers for revolution 1 (the
    control puts the reference in the program's place)."""
    C, R = ref.num_columns, ref.num_rows
    clusters = []
    for keys, st in zip(ref.clusters, ref.cluster_stamps):
        g, r = keys // R + C, keys % R
        rk = keys % (C * R)
        clusters.append(Cluster(g, r, ref.xyz[rk // R, rk % R], st))
    c, r = np.meshgrid(np.arange(C), np.arange(R), indexing="ij")
    cols = Columns(gcol=(c + C).reshape(-1), row=r.reshape(-1), present=ref.present.reshape(-1),
                   xyz=ref.xyz.reshape(-1, 3), ground=ref.ground.reshape(-1),
                   stamp=ref.stamp.reshape(-1), uidx=ref.uidx.reshape(-1))
    return clusters, cols


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without a number, fails."""
    return set(numbers) == set(limits) and all(
        np.isfinite(numbers[n]) and numbers[n] <= limits[n] for n in limits)
