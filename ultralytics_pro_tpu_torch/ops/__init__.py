"""Tensor ops of the port: boxes and rotated boxes, anchors, IoU and probiou, NMS
(axis-aligned and rotated) and instance masks."""

from ultralytics_pro_tpu_torch.ops.anchors import bbox2dist, dist2bbox, dist2rbox, make_anchors
from ultralytics_pro_tpu_torch.ops.boxes import clip_boxes, scale_boxes, xywh2xyxy, xywhr2xyxyxyxy
from ultralytics_pro_tpu_torch.ops.iou import batch_probiou, bbox_iou, probiou
from ultralytics_pro_tpu_torch.ops.masks import crop_mask, process_mask, process_mask_native, scale_masks
from ultralytics_pro_tpu_torch.ops.nms import (
    nms_indices,
    non_max_suppression,
    non_max_suppression_fused,
    non_max_suppression_rotated,
)

__all__ = ["batch_probiou", "bbox2dist", "bbox_iou", "clip_boxes", "crop_mask", "dist2bbox", "dist2rbox",
           "make_anchors", "nms_indices", "non_max_suppression", "non_max_suppression_fused",
           "non_max_suppression_rotated", "probiou", "process_mask", "process_mask_native", "scale_boxes",
           "scale_masks", "xywh2xyxy", "xywhr2xyxyxyxy"]
