"""One trainer step of yolo11n-efficientformerv2.yaml at 64 px in the port, in the port at float64 and in the JAX
trainer, on the CPU, stage 2's strided attention block (flax ("layers_0", "s2_b4")) moved in each:
tests/torch_yolo11_bb.py's `train_tests` says what it holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_yolo11_bb import train_tests

trained, test_trainer_step_matches_jax = train_tests("yolo11n-efficientformerv2.yaml", 64, ("layers_0", "s2_b4"))
