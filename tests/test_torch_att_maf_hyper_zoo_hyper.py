"""The Hyper-YOLO YAMLs (detect, segment, pose) whole against the JAX
package, on the CPU: tests/torch_att_maf_hyper.py says what they hold."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import blocked_imports_test, model_tests

NAMES = ["hyper-yolo-n.yaml", "hyper-yolo-n-seg.yaml", "hyper-yolo-n-pose.yaml"]
test_model_forward_matches_jax = model_tests(NAMES)
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(NAMES)
