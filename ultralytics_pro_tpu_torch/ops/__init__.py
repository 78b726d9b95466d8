"""Tensor ops of the port: boxes, anchors, IoU, NMS and instance masks."""

from ultralytics_pro_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from ultralytics_pro_tpu_torch.ops.boxes import clip_boxes, scale_boxes, xywh2xyxy
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou
from ultralytics_pro_tpu_torch.ops.masks import crop_mask, process_mask, process_mask_native, scale_masks
from ultralytics_pro_tpu_torch.ops.nms import (
    nms_indices,
    non_max_suppression,
    non_max_suppression_fused,
)

__all__ = ["bbox2dist", "bbox_iou", "clip_boxes", "crop_mask", "dist2bbox", "make_anchors", "nms_indices",
           "non_max_suppression", "non_max_suppression_fused", "process_mask", "process_mask_native",
           "scale_boxes", "scale_masks", "xywh2xyxy"]
