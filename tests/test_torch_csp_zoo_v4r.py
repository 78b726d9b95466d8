"""The YOLOv4-CSP (detect, segment) and YOLOR-CSP YAMLs, narrowed, whole
against the JAX package, on the CPU: tests/torch_csp_zoo.py says what they
hold."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_csp_zoo import model_tests

test_model_forward_matches_jax = model_tests(["yolov4-csp.yaml", "yolov4-csp-seg.yaml", "yolor-csp.yaml"])
