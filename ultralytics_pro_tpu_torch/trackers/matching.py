"""Track-to-detection costs and their assignment.

A copy of `ultralytics_pro_tpu/trackers/matching.py` (`linear_assignment:16`,
`iou_distance:32`, `embedding_distance:47`, `fuse_score:59`): scipy's
Hungarian `linear_sum_assignment` under a cost threshold, 1 - IoU through
`utils/metrics.py:box_iou_np` (the JAX `box_iou_np` line for line, cast to
float32 as there), so the assignment sees the same costs and breaks ties
the same way.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

from ultralytics_pro_tpu_torch.utils.metrics import box_iou_np


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Hungarian assignment of the pairs whose cost is at most thresh.

    Returns (matches (k, 2), unmatched rows, unmatched columns).
    """
    if cost_matrix.size == 0:
        return (np.empty((0, 2), dtype=int), tuple(range(cost_matrix.shape[0])),
                tuple(range(cost_matrix.shape[1])))
    row, col = scipy.optimize.linear_sum_assignment(cost_matrix)
    keep = cost_matrix[row, col] <= thresh
    matches = np.stack([row[keep], col[keep]], 1) if keep.any() else np.empty((0, 2), dtype=int)
    unmatched_a = tuple(set(range(cost_matrix.shape[0])) - set(matches[:, 0].tolist()))
    unmatched_b = tuple(set(range(cost_matrix.shape[1])) - set(matches[:, 1].tolist()))
    return matches, unmatched_a, unmatched_b


def _xyxy(tracks) -> np.ndarray:
    """(n, 4) xyxy of a list of tracks or of boxes."""
    if not len(tracks):
        return np.zeros((0, 4))
    if isinstance(tracks[0], np.ndarray):
        return np.asarray(tracks)
    return np.asarray([t.xyxy for t in tracks])


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU between two lists of tracks (or of xyxy boxes), float32."""
    a, b = _xyxy(atracks), _xyxy(btracks)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), dtype=np.float32)
    return 1.0 - box_iou_np(a, b).astype(np.float32)


def embedding_distance(tracks, detections) -> np.ndarray:
    """1 - cosine similarity of the tracks' smoothed features and the
    detections' own, clipped at 0."""
    cost = np.zeros((len(tracks), len(detections)), dtype=np.float32)
    if cost.size == 0:
        return cost
    det_features = np.asarray([d.curr_feat for d in detections], dtype=np.float32)
    track_features = np.asarray([t.smooth_feat for t in tracks], dtype=np.float32)
    a = track_features / (np.linalg.norm(track_features, axis=1, keepdims=True) + 1e-9)
    b = det_features / (np.linalg.norm(det_features, axis=1, keepdims=True) + 1e-9)
    return np.maximum(0.0, 1.0 - a @ b.T)


def fuse_score(cost_matrix: np.ndarray, detections) -> np.ndarray:
    """The IoU similarity times each detection's confidence, as a cost."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1 - cost_matrix
    det_scores = np.array([d.score for d in detections])
    fuse_sim = iou_sim * det_scores[None, :]
    return 1 - fuse_sim
