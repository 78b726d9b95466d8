"""YOLOv7 with its IDetect head and with the implicit anchor head
(yolov7-anchor), narrowed, against the JAX package, on the CPU.

1. Both YAMLs whole against the JAX flax module's `apply` at 64 px, the
   tree carried both ways (tests/torch_csp_zoo.py says what they hold).
2. Predict through both facades at nc 3 on the same seeded variables, 64 px:
   the same detections in the same order, boxes within 1e-3 px, scores
   within 1e-5. IDetect takes the generic decode and NMS (K1's plain version
   here), as the JAX predictor takes it for a head not named Detect; the
   implicit anchor head's 252 rows a 64-px image go through the same NMS.
3. yolov7's val of the detect fixture set through both facades at 64 px:
   each batch's NMS rows (valid and cls equal, scores within 1e-5, boxes
   1e-3 px) and every metric within 1e-6; both loaders shrink with cv2's
   INTER_AREA here.
"""

import shutil

import numpy as np
import pytest

from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import same_images_as_jax
from tests.torch_csp_zoo import NARROW, jax_and_port, model_tests
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

test_model_forward_matches_jax = model_tests(["yolov7.yaml", "yolov7-anchor.yaml"])


@pytest.fixture(scope="module")
def pairs():
    """name -> (port YOLO, JAX YOLO): a narrowed YAML at nc 3 in both facades,
    on the same seeded random variables."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    out = {}
    for seed, name in enumerate(("yolov7.yaml", "yolov7-anchor.yaml"), 10):
        jd = {**jyaml(name), **NARROW, "nc": 3}
        jyolo = JYOLO(dict(jd))
        _, jyolo.model.variables, _ = jax_and_port(name, seed=seed, d=jd)
        port = YOLO({**yaml_model_load(name), **NARROW, "nc": 3}, device="cpu")
        port.load_state_dict(jax_to_torch_state_dict(jyolo.model.variables))
        out[name] = port, jyolo
    return out


@pytest.mark.parametrize("name", ["yolov7.yaml", "yolov7-anchor.yaml"])
def test_predict_matches_jax(pairs, name):
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    port, jyolo = pairs[name]
    assert not port.model.model[-1].fused_single_label
    kw = dict(imgsz=64, conf=0.05)
    got, ref = port.predict(imgs, **kw), jyolo.predict(imgs, **kw)
    assert sum(len(r.boxes.data) for r in got) > 0
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert len(g.boxes.data) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)


def test_idetect_val_matches_jax(pairs, tmp_path, monkeypatch):
    from ultralytics_pro_tpu.engine.validator import DetectionValidator as JVal
    from ultralytics_pro_tpu_torch.engine.validator import DetectionValidator

    data = shutil.copytree(f"{FIXTURES}/torch_val_synth", tmp_path / "set") / "data.yaml"
    port, jyolo = pairs["yolov7.yaml"]
    rows = {"port": [], "jax": []}
    run, build = DetectionValidator.run, JVal._build_jit

    def jax_build(self, model):
        f = build(self, model)
        return lambda v, img: rows["jax"].append(f(v, img)) or rows["jax"][-1]

    monkeypatch.setattr(DetectionValidator, "run", lambda self, img: rows["port"].append(run(self, img)) or
                        rows["port"][-1])
    monkeypatch.setattr(JVal, "_build_jit", jax_build)
    kw = dict(imgsz=64, batch=8, conf=0.001)
    with same_images_as_jax():
        got = port.val(data=str(data), **kw)
    want = jyolo.val(data=str(data), plots=False, **kw)
    for k, v in want.results_dict.items():
        assert got.results_dict[k] == pytest.approx(float(v), abs=1e-6), k
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for out, ref in zip(rows["port"], rows["jax"]):
        assert out["boxes"].shape == (8, 300, 4) and int(out["valid"].sum()) > 0
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
        np.testing.assert_array_equal(out["cls"].numpy(), np.asarray(ref["cls"]))
        np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-3, rtol=0)
