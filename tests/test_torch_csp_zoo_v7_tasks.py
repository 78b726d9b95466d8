"""The YOLOv7 task YAMLs (ISegment, IPose, IOBB heads), narrowed, whole
against the JAX package, on the CPU: tests/torch_csp_zoo.py says what they
hold."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_csp_zoo import model_tests

test_model_forward_matches_jax = model_tests(["yolov7-seg.yaml", "yolov7-pose.yaml", "yolov7-obb.yaml"])
