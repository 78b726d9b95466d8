"""One trainer step of maf-yolov2n.yaml (E2EDetectLoss) at 64 px in the port against the JAX
trainer, on the CPU (its RepHMS at layer 4 moved): tests/torch_att_maf_hyper.py's `train_tests`
says what it holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import E2E_PARTS, blocked_imports_test, train_tests

trained, test_trainer_step_matches_jax = train_tests("maf-yolov2n.yaml", 64, E2E_PARTS, "layers_4")
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(["maf-yolov2n.yaml"])
