"""One trainer step of a narrowed YOLOv7 (IDetect head, v8DetectionLoss) in
the port against the JAX trainer, on the CPU: tests/torch_csp_zoo.py
(`train_tests`) says what it holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_csp_zoo import train_tests
from ultralytics_pro_tpu_torch.utils.loss import v8DetectionLoss

trained, test_trainer_step_matches_jax = train_tests("yolov7.yaml", v8DetectionLoss, ["box", "cls", "dfl"])
