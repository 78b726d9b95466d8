"""One trainer step of yolov8n-att.yaml at 64 px in the port against the JAX trainer, on the
CPU (its C2f_DCN at layer 13 moved): tests/torch_att_maf_hyper.py's `train_tests` says what it
holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import DETECT_PARTS, blocked_imports_test, train_tests

trained, test_trainer_step_matches_jax = train_tests("yolov8n-att.yaml", 64, DETECT_PARTS, "layers_13")
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(["yolov8n-att.yaml"])
