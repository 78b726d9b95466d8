"""One trainer step of yolov8n-DAttention.yaml at 64 px in the port against the JAX trainer, on
the CPU: tests/torch_attn_zoo.py's `train_tests` says what it holds."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_attn_zoo import train_tests

trained, test_trainer_step_matches_jax = train_tests("yolov8n-DAttention.yaml", 64)
