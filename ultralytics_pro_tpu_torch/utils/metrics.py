"""Detection, segment, pose and OBB metrics (TP matching, the AP family, the
confusion matrix, mask IoU and keypoint OKS), and classification's top-1
and top-5 accuracy.

A numpy copy of `ultralytics_pro_tpu/utils/metrics.py` (`box_iou_np:20`,
`match_predictions:35`, `smooth:63`, `compute_ap:71`, `ap_per_class:81`,
`Metric:130`, `DetMetrics:195`, `SegmentMetrics:253`, `PoseMetrics:290`,
`OBBMetrics:318`, `ClassifyMetrics:323`, `ConfusionMatrix:350`,
`mask_iou_np:405`) and of
`ultralytics_pro_tpu/ops/iou.py:kpt_iou:115`, which the port may not import.
`kpt_iou` computes in the inputs' f32 as the JAX function does.
`plot_curves` is left for the slice that ports plots.

Metrics run on the host in numpy: the device hands over fixed-shape
detections, and everything after is Python.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N,4) x (M,4) xyxy -> (N,M), numpy."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:4]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:4]
    inter = np.prod(np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None), axis=-1)
    area1 = np.prod(box1[:, 2:4] - box1[:, :2], axis=-1)[:, None]
    area2 = np.prod(box2[:, 2:4] - box2[:, :2], axis=-1)[None, :]
    return inter / (area1 + area2 - inter + eps)


IOUV = np.linspace(0.5, 0.95, 10)  # mAP50-95 thresholds


def match_predictions(pred_classes, true_classes, iou, iouv=IOUV) -> np.ndarray:
    """TP matrix (npr, len(iouv)) by greedy matching at each threshold: a
    match needs equal classes and IoU >= threshold; each gt and each
    prediction is used at most once, highest IoU first.

    Args:
        pred_classes: (npr,), true_classes: (ngt,), iou: (ngt, npr).
    """
    correct = np.zeros((pred_classes.shape[0], len(iouv)), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = iou * correct_class  # zero out wrong-class pairs
    for i, threshold in enumerate(iouv):
        gt_idx, pred_idx = np.nonzero(iou >= threshold)
        if gt_idx.shape[0]:
            ious = iou[gt_idx, pred_idx]
            order = ious.argsort()[::-1]
            gt_idx, pred_idx = gt_idx[order], pred_idx[order]
            # keep first (highest IoU) occurrence of each pred, then each gt
            keep = np.unique(pred_idx, return_index=True)[1]
            gt_idx, pred_idx = gt_idx[keep], pred_idx[keep]
            keep = np.unique(gt_idx, return_index=True)[1]
            gt_idx, pred_idx = gt_idx[keep], pred_idx[keep]
            correct[pred_idx, i] = True
    return correct


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing used for best-F1 selection."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16):
    """AP / P / R / F1 per class.

    Args:
        tp: (n_preds, n_iouv) bool TP matrix.
        conf: (n_preds,), pred_cls: (n_preds,), target_cls: (n_gts,).

    Returns dict with p, r, f1 (at best-F1 conf), ap (nc, n_iouv),
    unique_classes, and counts.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = np.zeros((nc, 1000))  # precision(recall) at IoU 0.5 (PR plot)
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values[ci] = np.interp(x, mrec, mpre)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()  # best-F1 confidence index
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    return {
        "p": p, "r": r, "f1": f1, "ap": ap,
        "unique_classes": unique_classes.astype(int), "nt": nt,
        "p_curve": p_curve, "r_curve": r_curve, "f1_curve": f1_curve, "x": x,
        "prec_values": prec_values,
    }


class Metric:
    """Holds per-class AP results."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = []
        self.ap_class_index = []
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return self.all_ap[:, 5].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i: int):
        return self.p[i], self.r[i], self.all_ap[i, 0], self.all_ap[i].mean()

    @property
    def maps(self):
        """Per-class mAP50-95 vector of length nc."""
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[int(c)] = self.ap[i]
        return maps

    def fitness(self):
        """0.1 * mAP50 + 0.9 * mAP."""
        return float(self.map50 * 0.1 + self.map * 0.9)

    def update(self, results: dict):
        self.p = results["p"]
        self.r = results["r"]
        self.f1 = results["f1"]
        self.all_ap = results["ap"]
        self.ap_class_index = results["unique_classes"]


class DetMetrics:
    """Aggregates detect-task statistics and computes the metric table."""

    def __init__(self, names: Dict[int, str] | None = None):
        self.names = names or {}
        self.box = Metric()
        self.box.nc = len(self.names)
        self.stats: Dict[str, List] = {"tp": [], "conf": [], "pred_cls": [], "target_cls": [], "target_img": []}
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    def update_stats(self, tp, conf, pred_cls, target_cls):
        self.stats["tp"].append(tp)
        self.stats["conf"].append(conf)
        self.stats["pred_cls"].append(pred_cls)
        self.stats["target_cls"].append(target_cls)

    def process(self):
        stats = {k: np.concatenate(v, 0) if v else np.zeros((0,)) for k, v in self.stats.items() if k != "target_img"}
        if len(stats.get("tp", [])) and stats["tp"].size:
            results = ap_per_class(stats["tp"], stats["conf"], stats["pred_cls"], stats["target_cls"])
            self.box.nc = max(self.box.nc, int(stats["target_cls"].max()) + 1 if stats["target_cls"].size else 0)
            self.box.update(results)
            self.curves = results  # p/r/f1 curves + prec_values for plotting
        return self

    def mean_results(self):
        return self.box.mean_results()

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def results_dict(self):
        keys = ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]
        return dict(zip(keys, self.mean_results())) | {"fitness": self.fitness}


class SegmentMetrics(DetMetrics):
    """Box and mask metrics."""

    def __init__(self, names=None):
        super().__init__(names)
        self.seg = Metric()
        self.seg_stats: Dict[str, List] = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}

    def update_stats(self, tp, conf, pred_cls, target_cls, tp_m=None):
        super().update_stats(tp, conf, pred_cls, target_cls)
        if tp_m is not None:
            for k, v in zip(("tp", "conf", "pred_cls", "target_cls"), (tp_m, conf, pred_cls, target_cls)):
                self.seg_stats[k].append(v)

    def process(self):
        super().process()
        stats = {k: np.concatenate(v, 0) if v else np.zeros((0,)) for k, v in self.seg_stats.items()}
        if len(stats.get("tp", [])) and stats["tp"].size:
            self.seg.update(ap_per_class(stats["tp"], stats["conf"], stats["pred_cls"], stats["target_cls"]))
        return self

    @property
    def fitness(self):
        return self.box.fitness() + self.seg.fitness()

    @property
    def results_dict(self):
        d = super().results_dict
        keys = ["metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"]
        d.update(dict(zip(keys, self.seg.mean_results())))
        d["fitness"] = self.fitness
        return d


class PoseMetrics(DetMetrics):
    """Box and keypoint (OKS) metrics. Its results_dict holds the box keys
    only, as the JAX class's does; the pose numbers are on `.pose`."""

    def __init__(self, names=None):
        super().__init__(names)
        self.pose = Metric()
        self.pose_stats: Dict[str, List] = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}

    def update_stats(self, tp, conf, pred_cls, target_cls, tp_p=None):
        super().update_stats(tp, conf, pred_cls, target_cls)
        if tp_p is not None:
            for k, v in zip(("tp", "conf", "pred_cls", "target_cls"), (tp_p, conf, pred_cls, target_cls)):
                self.pose_stats[k].append(v)

    def process(self):
        super().process()
        stats = {k: np.concatenate(v, 0) if v else np.zeros((0,)) for k, v in self.pose_stats.items()}
        if len(stats.get("tp", [])) and stats["tp"].size:
            self.pose.update(ap_per_class(stats["tp"], stats["conf"], stats["pred_cls"], stats["target_cls"]))
        return self

    @property
    def fitness(self):
        return self.box.fitness() + self.pose.fitness()


class OBBMetrics(DetMetrics):
    """Rotated-box metrics: DetMetrics, the validator matching by probiou."""


class ClassifyMetrics:
    """Top-1 and top-5 accuracy over the images seen; fitness is their mean.
    `names` is taken for the validator's interface and not read."""

    def __init__(self, names=None):
        self.top1 = 0.0
        self.top5 = 0.0
        self._correct = []

    def update(self, targets: np.ndarray, pred_top5: np.ndarray):
        """targets (n,) class indices, pred_top5 (n, k<=5) best classes first."""
        self._correct.append(pred_top5 == targets[:, None])

    def process(self):
        if self._correct:
            c = np.concatenate(self._correct, 0)
            self.top1 = float(c[:, 0].mean())
            self.top5 = float(c.any(1).mean())
        return self

    @property
    def fitness(self):
        return (self.top1 + self.top5) / 2

    @property
    def results_dict(self):
        return {"metrics/accuracy_top1": self.top1, "metrics/accuracy_top5": self.top5, "fitness": self.fitness}


def mask_iou_np(mask1: np.ndarray, mask2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU of flattened binary masks: (N, HW) x (M, HW) -> (N, M)."""
    inter = mask1 @ mask2.T
    union = mask1.sum(-1)[:, None] + mask2.sum(-1)[None, :] - inter
    return inter / (union + eps)


# COCO's 17 keypoint sigmas (the validator's OKS and the pose loss); any
# other keypoint count weighs each 1/nk
OKS_SIGMA = np.array([26, 25, 25, 35, 35, 79, 79, 72, 72, 62, 62, 107, 107, 87, 87, 89, 89],
                     np.float32) / 1000.0


def kpt_iou(kpt1: np.ndarray, kpt2: np.ndarray, area: np.ndarray, sigma, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity: ground truth (N, K, 3), predictions (M, K, 2|3),
    ground-truth areas (N,) -> (N, M): the mean of exp(-d^2 / (2 sigma)^2 /
    (area + eps) / 2) over each ground truth's visible keypoints."""
    f32 = np.float32
    kpt1, kpt2, area = kpt1.astype(f32), kpt2.astype(f32), np.asarray(area, f32)
    d = (kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2 + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2
    sigma = np.asarray(sigma, f32)
    kpt_mask = kpt1[..., 2] != 0
    e = d / ((2 * sigma) ** 2) / (area[:, None, None] + f32(eps)) / 2
    return (np.exp(-e) * kpt_mask[:, None, :]).sum(-1) / (kpt_mask.sum(-1)[:, None].astype(f32) + f32(eps))


class ConfusionMatrix:
    """Detection confusion matrix."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections, gt_bboxes, gt_cls):
        """detections (n, 6+) [xyxy, conf, cls]; gt (m, 4), gt_cls (m,)."""
        if gt_cls.shape[0] == 0:
            if detections is not None and len(detections):
                detections = detections[detections[:, 4] > self.conf]
                for dc in detections[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return

        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        detection_classes = detections[:, 5].astype(int)
        iou = box_iou_np(gt_bboxes, detections[:, :4])

        x = np.nonzero(iou > self.iou_thres)
        if x[0].shape[0]:
            matches = np.concatenate([np.stack(x, 1), iou[x[0], x[1]][:, None]], 1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[detection_classes[m1[j][0]], gc] += 1  # correct / confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(detection_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]
