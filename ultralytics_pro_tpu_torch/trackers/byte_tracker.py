"""BYTETracker: two-stage association of detections with Kalman tracks.

A copy of `ultralytics_pro_tpu/trackers/byte_tracker.py` (`TrackState:19`,
`BaseTrack:26` with its class-level id counter `next_id:41` and `reset_id:46`,
`STrack:56`, `BYTETracker:161`, `update:195`, `joint_stracks:290`,
`sub_stracks:295`, `remove_duplicate_stracks:300`): detections at or above
`track_high_thresh` match the tracks first by IoU (fused with their
confidence), those between the two thresholds get a second pass against the
tracks left, unconfirmed tracks a third, and a lost track waits
`track_buffer` frames. The id counter is shared by every tracker of the
process, as in the JAX package; a new tracker resets it. Host-side numpy,
one stream at a time.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ultralytics_pro_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH
from ultralytics_pro_tpu_torch.trackers.matching import fuse_score, iou_distance, linear_assignment


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class BaseTrack:
    _count = 0

    def __init__(self):
        self.track_id = 0
        self.is_activated = False
        self.state = TrackState.New
        self.frame_id = 0
        self.start_frame = 0

    @property
    def end_frame(self):
        return self.frame_id

    @staticmethod
    def next_id():
        BaseTrack._count += 1
        return BaseTrack._count

    @staticmethod
    def reset_id():
        BaseTrack._count = 0

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed


class STrack(BaseTrack):
    """One tracked object with an XYAH Kalman state."""

    shared_kalman = KalmanFilterXYAH()

    def __init__(self, xywh, score, cls):
        super().__init__()
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], dtype=np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.score = float(score)
        self.cls = cls
        self.idx = xywh[-1] if len(xywh) > 4 else -1
        self.tracklet_len = 0

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]  # aspect*h -> w
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        ret = self.tlwh
        return np.array([ret[0], ret[1], ret[0] + ret[2], ret[1] + ret[3]])

    @property
    def xywh(self):
        ret = self.tlwh
        return np.array([ret[0] + ret[2] / 2, ret[1] + ret[3] / 2, ret[2], ret[3]])

    @staticmethod
    def tlwh_to_xyah(tlwh):
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks):
        if not stracks:
            return
        multi_mean = np.asarray([st.mean.copy() for st in stracks])
        multi_cov = np.asarray([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                multi_mean[i][7] = 0
        multi_mean, multi_cov = STrack.shared_kalman.multi_predict(multi_mean, multi_cov)
        for i, (mean, cov) in enumerate(zip(multi_mean, multi_cov)):
            stracks[i].mean = mean
            stracks[i].covariance = cov

    @property
    def result(self):
        """[x1, y1, x2, y2, track_id, score, cls, det_idx]"""
        return [*self.xyxy, self.track_id, self.score, self.cls, self.idx]


class BYTETracker:
    """Two-stage association tracker of one stream."""

    def __init__(self, args=None, frame_rate: int = 30):
        args = args or {}
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = args.get("track_high_thresh", 0.25)
        self.track_low_thresh = args.get("track_low_thresh", 0.1)
        self.new_track_thresh = args.get("new_track_thresh", 0.25)
        self.match_thresh = args.get("match_thresh", 0.8)
        self.fuse_score_flag = args.get("fuse_score", True)
        self.buffer_size = int(frame_rate / 30.0 * args.get("track_buffer", 30))
        self.max_time_lost = self.buffer_size
        self.kalman_filter = self.get_kalmanfilter()
        BaseTrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, xywhs, scores, cls, img=None):
        return [STrack(x, s, c) for x, s, c in zip(xywhs, scores, cls)] if len(xywhs) else []

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        if self.fuse_score_flag:
            dists = fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def update(self, boxes_xyxy, scores, classes, img=None):
        """Per-frame update. boxes (n, 4) xyxy, scores (n,), classes (n,).

        Returns (m, 8) [x1, y1, x2, y2, id, score, cls, det_idx] for activated
        tracks.
        """
        self.frame_id += 1
        xywh = np.stack([
            (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2, (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2,
            boxes_xyxy[:, 2] - boxes_xyxy[:, 0], boxes_xyxy[:, 3] - boxes_xyxy[:, 1],
            np.arange(len(boxes_xyxy)),
        ], 1) if len(boxes_xyxy) else np.zeros((0, 5))

        remain_inds = scores >= self.track_high_thresh
        inds_low = (scores > self.track_low_thresh) & (scores < self.track_high_thresh)

        detections = self.init_track(xywh[remain_inds], scores[remain_inds], classes[remain_inds], img)
        detections_second = self.init_track(xywh[inds_low], scores[inds_low], classes[inds_low], img)

        activated, refind, lost, removed = [], [], [], []
        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)

        # First association: high-confidence detections
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_detection = linear_assignment(dists, thresh=self.match_thresh)
        for itracked, idet in matches:
            track, det = strack_pool[itracked], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # Second association: low-confidence detections vs remaining tracks
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, detections_second)
        matches, u_track2, _ = linear_assignment(dists, thresh=0.5)
        for itracked, idet in matches:
            track, det = r_tracked[itracked], detections_second[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for it in u_track2:
            track = r_tracked[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # Unconfirmed tracks vs remaining high-conf detections
        detections_left = [detections[i] for i in u_detection]
        dists = self.get_dists(unconfirmed, detections_left)
        matches, u_unconfirmed, u_detection2 = linear_assignment(dists, thresh=0.7)
        for itracked, idet in matches:
            unconfirmed[itracked].update(detections_left[idet], self.frame_id)
            activated.append(unconfirmed[itracked])
        for it in u_unconfirmed:
            track = unconfirmed[it]
            track.mark_removed()
            removed.append(track)

        # New tracks
        for inew in u_detection2:
            track = detections_left[inew]
            if track.score >= self.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # Expire stale lost tracks
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        self.removed_stracks = self.removed_stracks[-999:]

        return np.asarray([t.result for t in self.tracked_stracks if t.is_activated], dtype=np.float32)


def joint_stracks(a, b):
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a, b):
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(a, b):
    pdist = iou_distance(a, b)
    pairs = np.nonzero(pdist < 0.15)
    dup_a, dup_b = [], []
    for p, q in zip(*pairs):
        timep = a[p].frame_id - a[p].start_frame
        timeq = b[q].frame_id - b[q].start_frame
        if timep > timeq:
            dup_b.append(q)
        else:
            dup_a.append(p)
    return [t for i, t in enumerate(a) if i not in dup_a], [t for i, t in enumerate(b) if i not in dup_b]
