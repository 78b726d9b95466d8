"""One trainer step of yolo11n-ghostnetv2.yaml at 64 px in the port, in the port at float64 and in the JAX
trainer, on the CPU, a DFC-gated ghost bottleneck with SE (flax ("layers_0", "b3")) moved in each:
tests/torch_yolo11_bb.py's `train_tests` says what it holds. The JAX package's float32 step lands
1.4e-4 of the tree's largest magnitude from the port's float64 step (the stem and block 0's ghost
convs, behind 17 train-mode BatchNorms a block), where the port's float32 step is within 2.6e-7 of
it (its BN statistics: 1.3e-4 and 1.2e-6); so its parameters, EMA and BN statistics are held to
the JAX run within 1e-3 and to the port's float64 run within 1e-4."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_yolo11_bb import train_tests

trained, test_trainer_step_matches_jax = train_tests("yolo11n-ghostnetv2.yaml", 64, ("layers_0", "b3"), jax_tol=1e-3)
