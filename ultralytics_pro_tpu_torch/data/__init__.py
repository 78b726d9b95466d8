"""Data of the port: image reading, transforms, polygon rasterising, the
minimum-area rectangle of OBB labels, the detect, segment, pose and obb
datasets and the loader."""

from ultralytics_pro_tpu_torch.data.augment import Compose, LetterBox, resize_area, resize_bilinear
from ultralytics_pro_tpu_torch.data.build import DataLoader, collate_detect
from ultralytics_pro_tpu_torch.data.dataset import YOLODataset
from ultralytics_pro_tpu_torch.data.image_io import imread
from ultralytics_pro_tpu_torch.data.utils import check_det_dataset

__all__ = ["Compose", "DataLoader", "LetterBox", "YOLODataset", "check_det_dataset",
           "collate_detect", "imread", "resize_area", "resize_bilinear"]
