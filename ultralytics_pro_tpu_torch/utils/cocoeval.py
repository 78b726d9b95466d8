"""COCO bbox evaluation in numpy, without pycocotools.

A copy of `ultralytics_pro_tpu/utils/cocoeval.py` (`COCOEvalNp:59`): the COCO
protocol for boxes, per-(image, category) IoU, greedy score-ordered matching
at each IoU threshold with crowd and ignore handling, 101-point precision
interpolation, area ranges and maxDets 100.

API:
    ev = COCOEvalNp(gt_dict_or_path, pred_list_or_path)
    stats = ev.run()   # {"map50-95": ..., "map50": ..., "map75": ...,
                       #  "small": ..., "medium": ..., "large": ...}
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Union

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _load(obj):
    if isinstance(obj, (str,)):
        with open(obj) as f:
            return json.load(f)
    return obj


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """COCO IoU: boxes are [x, y, w, h]; crowd GT uses intersection/dt-area."""
    if not len(dt) or not len(gt):
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / union, 0.0)


class COCOEvalNp:
    def __init__(self, gt: Union[str, Dict], pred: Union[str, List[Dict]]):
        gt = _load(gt)
        pred = _load(pred)
        self.img_ids = sorted({im["id"] for im in gt.get("images", [])} or
                              {a["image_id"] for a in gt["annotations"]})
        self.cat_ids = sorted({c["id"] for c in gt.get("categories", [])} or
                              {a["category_id"] for a in gt["annotations"]})
        self.gts = defaultdict(list)
        for a in gt["annotations"]:
            self.gts[(a["image_id"], a["category_id"])].append(a)
        self.dts = defaultdict(list)
        for d in pred:
            self.dts[(d["image_id"], d["category_id"])].append(d)

    def _evaluate_img(self, img_id, cat_id, area_rng):
        gts = self.gts.get((img_id, cat_id), [])
        dts = sorted(self.dts.get((img_id, cat_id), []),
                     key=lambda d: -d["score"])[:MAX_DETS]
        if not gts and not dts:
            return None
        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        g_area = np.array([g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts]) \
            if gts else np.zeros(0)
        g_ignore = np.array(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
             or not (area_rng[0] <= a <= area_rng[1])
             for g, a in zip(gts, g_area)], bool)
        # gt order: unignored first (pycocotools sorts by ignore flag)
        g_order = np.argsort(g_ignore, kind="stable")
        g_boxes, g_crowd, g_ignore = g_boxes[g_order], g_crowd[g_order], g_ignore[g_order]

        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        d_scores = np.array([d["score"] for d in dts], np.float64)
        ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd)

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_m = np.zeros((T, D), np.int64) - 1
        gt_m = np.zeros((T, G), np.int64) - 1
        dt_ig = np.zeros((T, D), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gt_m[ti, gi] >= 0 and not g_crowd[gi]:
                        continue
                    # stop at ignored gts once a real match was found
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = g_ignore[best_g]
                dt_m[ti, di] = best_g
                gt_m[ti, best_g] = di
        # unmatched dets outside the area range are ignored
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        out_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dt_m == -1) & out_rng[None, :])
        return {
            "dt_scores": d_scores, "dt_matched": dt_m >= 0, "dt_ignore": dt_ig,
            "n_gt": int((~g_ignore).sum()),
        }

    def _accumulate(self, area_name="all"):
        area_rng = AREA_RNG[area_name]
        T, R, K = len(IOU_THRS), len(REC_THRS), len(self.cat_ids)
        precision = -np.ones((T, R, K))
        for ki, cat in enumerate(self.cat_ids):
            evals = [self._evaluate_img(i, cat, area_rng) for i in self.img_ids]
            evals = [e for e in evals if e is not None]
            if not evals:
                continue
            scores = np.concatenate([e["dt_scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            matched = np.concatenate([e["dt_matched"] for e in evals], axis=1)[:, order]
            ignored = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            n_gt = sum(e["n_gt"] for e in evals)
            if n_gt == 0:
                continue
            for ti in range(T):
                keep = ~ignored[ti]
                tps = (matched[ti] & keep).astype(np.float64)
                fps = (~matched[ti] & keep).astype(np.float64)
                tp_c = np.cumsum(tps)
                fp_c = np.cumsum(fps)
                rc = tp_c / n_gt
                pr = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
                # precision envelope (monotone decreasing from the right)
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ki] = q
        return precision

    def run(self) -> Dict[str, float]:
        p = self._accumulate("all")

        def mean_ap(prec):
            valid = prec[prec > -1]
            return float(valid.mean()) if valid.size else 0.0

        out = {
            "map50-95": mean_ap(p),
            "map50": mean_ap(p[0]),
            "map75": mean_ap(p[5]),
        }
        for name in ("small", "medium", "large"):
            out[name] = mean_ap(self._accumulate(name))
        return out
