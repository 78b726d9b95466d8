"""yolo11-repvit, yolo11-starnet, yolo11-mobilenetv4 and yolo11-fasternet
whole against the JAX package, on the CPU: tests/torch_yolo11_bb.py says
what it holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import blocked_imports_test
from tests.torch_yolo11_bb import model_tests, yaml_and_parse_tests

NAMES = ("repvit", "starnet", "mobilenetv4", "fasternet")
test_yaml_copy_is_the_jax_package_file, test_parse_matches_the_jax_specs = yaml_and_parse_tests(NAMES)
test_model_forward_matches_jax = model_tests([f"yolo11n-{n}.yaml" for n in NAMES])
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test([f"yolo11n-{n}.yaml" for n in NAMES])
