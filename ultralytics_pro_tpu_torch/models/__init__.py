"""Task bindings: the predictor, validator and trainer for a model
(detect, segment, pose and obb, and RT-DETR's NMS-free predictor).

Segment, pose and obb have no trainer yet: their entries raise
NotImplementedError naming the loss that is still to port."""

from ultralytics_pro_tpu_torch.engine.predictor import (
    DetectionPredictor,
    OBBPredictor,
    PosePredictor,
    SegmentationPredictor,
)
from ultralytics_pro_tpu_torch.engine.trainer import DetectionTrainer
from ultralytics_pro_tpu_torch.engine.validator import (
    DetectionValidator,
    OBBValidator,
    PoseValidator,
    SegmentationValidator,
)
from ultralytics_pro_tpu_torch.models.rtdetr import RTDETR, RTDETRPredictor
from ultralytics_pro_tpu_torch.nn.modules.head import RTDETRDecoder


def _unported_trainer(task: str, loss: str):
    def trainer(*args, **kwargs):
        raise NotImplementedError(
            f"training a {task} model is not implemented in ultralytics_pro_tpu_torch yet: it needs "
            f"the JAX package's utils/loss.py:{loss} (ROADMAP.md queue 1 item 5)")
    return trainer


task_map = {"detect": {"predictor": DetectionPredictor, "validator": DetectionValidator,
                       "trainer": DetectionTrainer},
            "segment": {"predictor": SegmentationPredictor, "validator": SegmentationValidator,
                        "trainer": _unported_trainer("segment", "v8SegmentationLoss")},
            "pose": {"predictor": PosePredictor, "validator": PoseValidator,
                     "trainer": _unported_trainer("pose", "v8PoseLoss")},
            "obb": {"predictor": OBBPredictor, "validator": OBBValidator,
                    "trainer": _unported_trainer("obb", "v8OBBLoss")},
            "rtdetr": {"predictor": RTDETRPredictor}}


def predictor_for(model, task: str):
    """The predictor class for a built model: an RTDETRDecoder head goes to
    RTDETRPredictor whatever the task, any other to the task's predictor."""
    return task_map["rtdetr" if isinstance(model.model[-1], RTDETRDecoder) else task]["predictor"]


__all__ = ["RTDETR", "RTDETRPredictor", "predictor_for", "task_map"]
