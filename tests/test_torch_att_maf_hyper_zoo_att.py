"""yolov8-att (BoT3, CoordAtt, C2f_DCN, C2f_DLKA) whole against the JAX
package, on the CPU: tests/torch_att_maf_hyper.py says what it holds. Its
blocked-imports test also trains maf-yolov2n-mafdetect an epoch at 32 px
there."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import blocked_imports_test, model_tests

test_model_forward_matches_jax = model_tests(["yolov8n-att.yaml"])
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(["yolov8n-att.yaml"], train="maf-yolov2n-mafdetect.yaml")
