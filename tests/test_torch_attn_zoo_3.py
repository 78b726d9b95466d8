"""Fifth 3 of the 20 attention modules' whole-model checks against the JAX
package, on the CPU: tests/torch_attn_zoo.py says what they hold."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_attn_zoo import model_tests

test_yaml_copy_is_the_jax_package_file, test_model_forward_matches_jax, test_model_loads_the_jax_variables = \
    model_tests(2)
