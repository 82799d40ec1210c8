"""SemanticKITTI evaluation: ground segmentation P/R/F1/Acc + TRAVEL OSE/USE
(the port's copy of ``continuous_clustering_tpu/evaluation/kitti_evaluation.py``;
host-side NumPy, no device work).

NumPy re-derivation of the reference evaluation
(``src/evaluation/kitti_evaluation.cpp``): per-frame ground-point confusion
counts against the SemanticKITTI ground classes, Over-/Under-Segmentation
Entropy from GT↔detection label cross-histograms, per-sequence + pooled
accumulation and the Markdown results table including the hardcoded TRAVEL
baseline row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .kitti_loader import GROUND_LABEL_IDS, UNLABELED_ID


@dataclass
class FrameResult:
    """(reference EvaluationResultForFrame, kitti_evaluation.hpp:38-48)."""

    tp: float = 0.0
    fn: float = 0.0
    fp: float = 0.0
    tn: float = 0.0
    ose: float = 0.0
    use: float = 0.0


def evaluate_ground_points(
    semantic: np.ndarray, is_ground_pred: np.ndarray, result: FrameResult
) -> None:
    """(…cpp:44-84): unlabeled skipped; GT ground = 6 ground classes."""
    labeled = semantic != UNLABELED_ID
    gt = np.isin(semantic, list(GROUND_LABEL_IDS)) & labeled
    pred = is_ground_pred.astype(bool)
    result.tp += float(np.sum(labeled & gt & pred))
    result.fn += float(np.sum(labeled & gt & ~pred))
    result.fp += float(np.sum(labeled & ~gt & pred))
    result.tn += float(np.sum(labeled & ~gt & ~pred))


def evaluate_clusters(
    gt_label: np.ndarray, det_label: np.ndarray, result: FrameResult
) -> None:
    """OSE/USE entropies (…cpp:86-146).

    OSE: for every GT cluster, entropy of its split over detection labels
    (including detection label 0).  USE: for every detection cluster that
    contains at least one GT-labeled point, entropy of its split over GT
    labels (including GT label 0).
    """
    gt_label = gt_label.astype(np.int64)
    det_label = det_label.astype(np.int64)

    # over-segmentation: GT clusters split by detection labels
    gmask = gt_label != 0
    if gmask.any():
        g = gt_label[gmask]
        d = det_label[gmask]
        pairs, counts = np.unique(np.stack([g, d]), axis=1, return_counts=True)
        g_tot = np.bincount(g)[pairs[0]]
        frac = counts / g_tot
        result.ose += float(-np.sum(frac * np.log(frac)))

    # under-segmentation: detection clusters split by GT labels, skipping
    # detections whose only GT label is 0
    dmask = det_label != 0
    if dmask.any():
        d = det_label[dmask]
        g = gt_label[dmask]
        pairs, counts = np.unique(np.stack([d, g]), axis=1, return_counts=True)
        # detections with at least one nonzero GT point
        has_gt = np.zeros(int(d.max()) + 1, dtype=bool)
        has_gt[pairs[0][pairs[1] != 0]] = True
        keep = has_gt[pairs[0]]
        if keep.any():
            d_tot = np.bincount(d)[pairs[0][keep]]
            frac = counts[keep] / d_tot
            result.use += float(-np.sum(frac * np.log(frac)))


TRAVEL_ROW = (
    "| All (**TRAVEL**) | 90.0 / - | 96.7 / - | 93.1 / 4.3 | 93.9 / 3.7 "
    "| 24.07 / 11.8 | 70.40 / 34.44 |"
)


class KittiEvaluation:
    """Per-sequence + pooled accumulation and reporting (…cpp:29-213)."""

    def __init__(self) -> None:
        self.per_sequence: Dict[int, List[FrameResult]] = {-1: []}

    def evaluate_frame(
        self,
        semantic: np.ndarray,
        is_ground_pred: np.ndarray,
        gt_cluster_label: np.ndarray,
        det_cluster_label: np.ndarray,
        sequence_index: int,
    ) -> FrameResult:
        r = FrameResult()
        evaluate_ground_points(semantic, is_ground_pred, r)
        evaluate_clusters(gt_cluster_label, det_cluster_label, r)
        self.per_sequence.setdefault(sequence_index, []).append(r)
        self.per_sequence[-1].append(r)
        return r

    @staticmethod
    def _mean_std(values: List[float]):
        if not values:
            return float("nan"), float("nan")
        m = float(np.mean(values))
        s = float(np.sqrt(np.mean((np.asarray(values) - m) ** 2)))
        return m, s

    def generate_evaluation_results(self) -> str:
        """Markdown table matching the reference layout (…cpp:159-213)."""
        lines = [
            "| Sequence | Recall &mu; &uarr; / &sigma; &darr; | Precision &mu; "
            "&uarr; / &sigma; &darr; | F1-Score &mu; &uarr; / &sigma; &darr; | "
            "Accuracy &mu; &uarr; / &sigma; &darr; | USE &mu; &darr; / &sigma; "
            "&darr; | OSE &mu; &darr; / &sigma; &darr; |",
            "| :---: | :---: | :---: | :---: | :---: | :---: | :---: |",
            TRAVEL_ROW,
        ]

        def metrics(frames: List[FrameResult]):
            def safe(n, d):
                return n / d if d else float("nan")

            recall = [safe(r.tp, r.tp + r.fn) for r in frames]
            precision = [safe(r.tp, r.tp + r.fp) for r in frames]
            f1 = [safe(2 * r.tp, 2 * r.tp + r.fp + r.fn) for r in frames]
            acc = [safe(r.tp + r.tn, r.tp + r.tn + r.fp + r.fn) for r in frames]
            use = [r.use for r in frames]
            ose = [r.ose for r in frames]
            return recall, precision, f1, acc, use, ose

        for seq in sorted(self.per_sequence):
            frames = self.per_sequence[seq]
            if not frames:
                continue
            name = "All (**Ours**)" if seq == -1 else str(seq)
            cells = []
            for i, vals in enumerate(metrics(frames)):
                m, s = self._mean_std(vals)
                if i < 4:
                    cells.append(f"{m * 100:.2f} / {s * 100:.2f}")
                else:
                    cells.append(f"{m:.2f} / {s:.2f}")
            lines.append("| " + name + " | " + " | ".join(cells) + " |")
        return "\n".join(lines) + "\n"
