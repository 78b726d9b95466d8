"""One trainer step of a narrowed yolov7-anchor (the implicit anchor head,
v5AnchorLoss) in the port against the JAX trainer, on the CPU:
tests/torch_csp_zoo.py (`train_tests`) says what it holds. The JAX package's
float32 step lands 1.9e-4 of the tree's largest magnitude from the port's
float64 step in the stem's kernels, where the port's float32 step is within
2e-7 of it; so its parameters are held to the JAX run within 1e-3 and to
the port's float64 run within 1e-4."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_csp_zoo import train_tests
from ultralytics_pro_tpu_torch.utils.loss import v5AnchorLoss

trained, test_trainer_step_matches_jax = train_tests("yolov7-anchor.yaml", v5AnchorLoss, ["box", "obj", "cls"],
                                                         jax_params_tol=1e-3)
