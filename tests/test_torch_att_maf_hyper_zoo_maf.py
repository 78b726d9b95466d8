"""The MAF-YOLOv2 YAMLs (v10Detect, MAFDetect, MAFSegment, MAFPose, MAFOBB)
whole against the JAX package, on the CPU: tests/torch_att_maf_hyper.py says
what they hold."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import blocked_imports_test, model_tests

NAMES = ["maf-yolov2n.yaml", "maf-yolov2n-mafdetect.yaml", "maf-yolov2n-mafseg.yaml", "maf-yolov2n-mafpose.yaml",
         "maf-yolov2n-mafobb.yaml"]
test_model_forward_matches_jax = model_tests(NAMES)
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(NAMES)
