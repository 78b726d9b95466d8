"""yolo11-efficientformerv2, yolo11-efficientvit and yolo11-efficientnetv2
whole against the JAX package, on the CPU (tests/torch_yolo11_bb.py says
what it holds), and EfficientFormerV2's size binding against the JAX
facade's."""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_att_maf_hyper import blocked_imports_test
from tests.torch_yolo11_bb import model_tests, yaml_and_parse_tests
from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

NAMES = ("efficientformerv2", "efficientvit", "efficientnetv2")
test_yaml_copy_is_the_jax_package_file, test_parse_matches_the_jax_specs = yaml_and_parse_tests(NAMES)
test_model_forward_matches_jax = model_tests([f"yolo11n-{n}.yaml" for n in NAMES])
test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test([f"yolo11n-{n}.yaml" for n in NAMES])


@pytest.mark.parametrize("write", ["load_state_dict", "in_place"])
def test_written_efficientformerv2_weights_survive_a_call_at_another_size(write):
    """`YOLO("yolo11n-efficientformerv2.yaml")`, its weights written through
    the module's own load_state_dict or in place, then predict at 320 px:
    the port raises a ValueError naming attention_biases and keeps the
    written weights (the model stays bound to 640); the JAX facade, given
    the same written variables, raises ScopeParamShapeError naming
    attention_biases. A model left as built is rebuilt at the call's size,
    its biases sized for the 320 px grids."""
    from flax.errors import ScopeParamShapeError

    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu_torch import YOLO

    img = np.zeros((40, 48, 3), np.uint8)
    cfg = "yolo11n-efficientformerv2.yaml"
    py = YOLO(cfg, device="cpu")
    seed = {k: v.clone() for k, v in py.model.state_dict().items()}
    written = {k: v * 1.5 if v.is_floating_point() else v for k, v in seed.items()}
    if write == "load_state_dict":
        py.model.load_state_dict(written)
    else:
        with torch.no_grad():
            for k, t in py.model.state_dict().items():
                t.copy_(written[k])
    jy = JYOLO(cfg)
    jy.model.variables = torch_state_dict_to_jax(written)
    with pytest.raises(ScopeParamShapeError, match="attention_biases"):
        jy.predict([img], imgsz=320, conf=0.5)
    with pytest.raises(ValueError, match="attention_biases"):
        py.predict([img], imgsz=320, conf=0.5)
    backbone = py.model.model[0]
    assert py.model.imgsz == 640 and backbone.s3_b2.token_mixer.attention_biases.shape == (8, 400)
    assert all(torch.equal(v, written[k]) for k, v in py.model.state_dict().items())
    fresh = YOLO(cfg, device="cpu")
    fresh.predict([img], imgsz=320, conf=0.5)
    assert fresh.model.imgsz == 320 and fresh.model.model[0].s3_b2.token_mixer.attention_biases.shape == (8, 100)
