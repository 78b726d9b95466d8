"""BoT-SORT: ByteTrack with camera-motion compensation and, optionally, ReID.

A copy of `ultralytics_pro_tpu/trackers/bot_sort.py` (`GMC:18`, `BOTrack:68`,
`BOTSORT:157`, `ReID:204`): tracks hold an XYWH Kalman state and a smoothed
appearance feature; before each association the tracks are warped by the
camera's motion between frames, and with ReID the IoU cost is lowered to the
halved appearance cost where both are close enough.

GMC runs the JAX package's three OpenCV calls through their numpy copies in
`data/flow.py` (`good_features_to_track`, `calc_optical_flow_pyr_lk`,
`estimate_affine_partial_2d`), on the frame turned grey and halved by the
copies in `data/imgproc.py`. Like the JAX package, `BOTrack.multi_predict`
is `STrack`'s, so the tracks' prediction takes the XYAH filter's noise.

`ReID` embeds each detection's crop through a model's `embed`. The tracker
YAML's `model: auto` means the tracking model itself (the reference's
meaning: the detector's own features); the JAX package reads "auto" as a
model YAML's name and raises (ROADMAP.md section 3).
"""

from __future__ import annotations

import numpy as np

from ultralytics_pro_tpu_torch.data.flow import (
    calc_optical_flow_pyr_lk,
    estimate_affine_partial_2d,
    good_features_to_track,
)
from ultralytics_pro_tpu_torch.data.imgproc import bgr2gray, resize_linear
from ultralytics_pro_tpu_torch.trackers.byte_tracker import BYTETracker, STrack, TrackState
from ultralytics_pro_tpu_torch.trackers.kalman_filter import KalmanFilterXYWH
from ultralytics_pro_tpu_torch.trackers.matching import embedding_distance, fuse_score, iou_distance


class GMC:
    """Global (camera) motion between consecutive frames from sparse optical
    flow: corners of the previous frame followed into this one by pyramidal
    Lucas-Kanade, then a RANSAC similarity fit. `apply` returns the (2, 3)
    affine of the previous frame into this one, in full-size pixels."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prevFrame = None
        self.prevKeyPoints = None
        self.initializedFirstFrame = False

    def apply(self, raw_frame: np.ndarray, detections=None) -> np.ndarray:
        if self.method in {"none", None}:
            return np.eye(2, 3)
        frame = bgr2gray(raw_frame)
        if self.downscale > 1:
            frame = resize_linear(frame, (frame.shape[1] // self.downscale, frame.shape[0] // self.downscale))
        H = np.eye(2, 3)
        keypoints = good_features_to_track(frame, max_corners=1000, quality_level=0.01, min_distance=1,
                                           block_size=3)
        if not self.initializedFirstFrame or keypoints is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = keypoints
            self.initializedFirstFrame = True
            return H
        if self.prevKeyPoints is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = keypoints
            return H
        matched, status, _ = calc_optical_flow_pyr_lk(self.prevFrame, frame, self.prevKeyPoints)
        prev_pts = self.prevKeyPoints[status.flatten() == 1]
        curr_pts = matched[status.flatten() == 1]
        if len(prev_pts) > 4:
            M, _ = estimate_affine_partial_2d(prev_pts, curr_pts)
            if M is not None:
                H = M
                if self.downscale > 1:
                    H[0, 2] *= self.downscale
                    H[1, 2] *= self.downscale
        self.prevFrame = frame.copy()
        self.prevKeyPoints = keypoints
        return H


class BOTrack(STrack):
    """STrack with an XYWH Kalman state and a smoothed appearance feature."""

    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat=None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-9)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-9

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # cx, cy, w, h
        ret[:2] -= ret[2:] / 2
        return ret

    @staticmethod
    def tlwh_to_xywh(tlwh):
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xywh(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xywh(new_track.tlwh)
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
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xywh(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    @staticmethod
    def multi_gmc(stracks, H=np.eye(2, 3)):
        """Warp the tracks' states by the camera's affine H (2, 3)."""
        if not stracks:
            return
        R = H[:2, :2]
        R8x8 = np.kron(np.eye(4), R)
        t = H[:2, 2]
        for st in stracks:
            mean = R8x8 @ st.mean
            mean[:2] += t
            st.mean = mean
            st.covariance = R8x8 @ st.covariance @ R8x8.T


class BOTSORT(BYTETracker):
    """ByteTrack with GMC, and ReID when `with_reid` is set and an encoder is given."""

    def __init__(self, args=None, frame_rate: int = 30, encoder=None):
        args = args or {}
        super().__init__(args, frame_rate)
        self.proximity_thresh = args.get("proximity_thresh", 0.5)
        self.appearance_thresh = args.get("appearance_thresh", 0.25)
        self.with_reid = bool(args.get("with_reid", False)) and encoder is not None
        self.encoder = encoder
        self.gmc = GMC(method=args.get("gmc_method", "sparseOptFlow"))

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, xywhs, scores, cls, img=None):
        if len(xywhs) == 0:
            return []
        if self.with_reid and img is not None:
            feats = self.encoder(img, xywhs[:, :4])
            return [BOTrack(x, s, c, f) for x, s, c, f in zip(xywhs, scores, cls, feats)]
        return [BOTrack(x, s, c) for x, s, c in zip(xywhs, scores, cls)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if self.fuse_score_flag:
            dists = fuse_score(dists, detections)
        if self.with_reid:
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def update(self, boxes_xyxy, scores, classes, img=None):
        if img is not None:
            H = self.gmc.apply(img)
            BOTrack.multi_gmc(self.tracked_stracks, H)
            BOTrack.multi_gmc(self.lost_stracks, H)
        return super().update(boxes_xyxy, scores, classes, img)


class ReID:
    """A model's `embed` as the appearance encoder: each detection's crop of
    the frame, clipped to it, resized to imgsz and pooled from the model's
    last neck maps. `model` is a facade (the tracking model for `model:
    auto`) or a model YAML's name, built on `device`."""

    def __init__(self, model="yolov8n.yaml", imgsz: int = 128, device="cuda"):
        from ultralytics_pro_tpu_torch.engine.model import YOLO  # engine/ imports this package

        self.model = model if not isinstance(model, str) else YOLO(model, device=device)
        self.imgsz = imgsz

    def __call__(self, img: np.ndarray, dets: np.ndarray):
        """img: the BGR HWC frame; dets: (N, 4+) xywh. Returns a list of (D,) features."""
        h, w = img.shape[:2]
        crops = []
        for d in np.atleast_2d(np.asarray(dets, np.float32)):
            cx, cy, bw, bh = d[:4]
            x1 = int(max(cx - bw / 2, 0))
            y1 = int(max(cy - bh / 2, 0))
            x2 = int(min(cx + bw / 2, w - 1) + 1)
            y2 = int(min(cy + bh / 2, h - 1) + 1)
            crops.append(img[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)])
        return list(self.model.embed(crops, imgsz=self.imgsz))
