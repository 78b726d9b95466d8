"""Task bindings: the predictor, validator and trainer for a model
(detect, segment, pose, obb and classify, and RT-DETR's NMS-free predictor
and validator and its trainer)."""

from ultralytics_pro_tpu_torch.engine.predictor import (
    ClassificationPredictor,
    DetectionPredictor,
    OBBPredictor,
    PosePredictor,
    SegmentationPredictor,
)
from ultralytics_pro_tpu_torch.engine.trainer import (
    ClassificationTrainer,
    DetectionTrainer,
    OBBTrainer,
    PoseTrainer,
    SegmentationTrainer,
)
from ultralytics_pro_tpu_torch.engine.validator import (
    ClassificationValidator,
    DetectionValidator,
    OBBValidator,
    PoseValidator,
    SegmentationValidator,
)
from ultralytics_pro_tpu_torch.models.rtdetr import RTDETR, RTDETRPredictor, RTDETRTrainer, RTDETRValidator
from ultralytics_pro_tpu_torch.nn.modules.head import RTDETRDecoder


task_map = {"detect": {"predictor": DetectionPredictor, "validator": DetectionValidator,
                       "trainer": DetectionTrainer},
            "segment": {"predictor": SegmentationPredictor, "validator": SegmentationValidator,
                        "trainer": SegmentationTrainer},
            "pose": {"predictor": PosePredictor, "validator": PoseValidator,
                     "trainer": PoseTrainer},
            "obb": {"predictor": OBBPredictor, "validator": OBBValidator,
                    "trainer": OBBTrainer},
            "classify": {"predictor": ClassificationPredictor, "validator": ClassificationValidator,
                         "trainer": ClassificationTrainer},
            "rtdetr": {"predictor": RTDETRPredictor, "validator": RTDETRValidator, "trainer": RTDETRTrainer}}


def predictor_for(model, task: str):
    """The predictor class for a built model: an RTDETRDecoder head goes to
    RTDETRPredictor whatever the task, any other to the task's predictor."""
    return task_map["rtdetr" if isinstance(model.model[-1], RTDETRDecoder) else task]["predictor"]


__all__ = ["RTDETR", "RTDETRPredictor", "RTDETRTrainer", "RTDETRValidator", "predictor_for", "task_map"]
