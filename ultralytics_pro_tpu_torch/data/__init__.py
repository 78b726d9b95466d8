"""Data of the port: image reading, transforms, polygon rasterising, the
minimum-area rectangle of OBB labels, the detect, segment, pose, obb and
classify datasets and the loader."""

from ultralytics_pro_tpu_torch.data.augment import (
    Compose,
    LetterBox,
    classify_transforms,
    resize_area,
    resize_bilinear,
)
from ultralytics_pro_tpu_torch.data.build import DataLoader, collate_classify, collate_detect
from ultralytics_pro_tpu_torch.data.dataset import ClassificationDataset, YOLODataset
from ultralytics_pro_tpu_torch.data.image_io import imread, imsize, imwrite
from ultralytics_pro_tpu_torch.data.utils import check_cls_dataset, check_det_dataset

__all__ = ["ClassificationDataset", "Compose", "DataLoader", "LetterBox", "YOLODataset", "check_cls_dataset",
           "check_det_dataset", "classify_transforms", "collate_classify", "collate_detect", "imread", "imsize",
           "imwrite", "resize_area", "resize_bilinear"]
