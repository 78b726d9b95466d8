"""The port's yolov8n and its predict slice against the JAX package.

1. Forward: the reference's seeded yolov8n state_dict (`model_yolov8n.npz`)
   loads strictly into the port and, through `load_torch_state_dict`, into
   JAX; both run the fixture's 64 px input (NCHW for the port, NHWC for JAX,
   as in test_model_parity.py:37-39). Decoded outputs agree within boxes
   1e-3 px and scores 1e-5.
2. The slice: `YOLO("yolov8n.yaml", device="cpu").predict(...)` against the
   JAX `YOLO(...).predict(...)` with the same weights on two seeded images.
   The images are no larger than imgsz, so (scaleup=False) letterboxing only
   pads and both sides see the same pixels: the resize itself differs by up
   to one grey level between cv2 and F.interpolate and is held separately in
   test_torch_io.py. Detections agree in count and class exactly, boxes
   within 1e-3 px, scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, load_fixture
from tests.test_torch_modules import randomize, torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, load_torch_state_dict_file


def test_yolov8n_forward_matches_jax_on_fixture():
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel
    from ultralytics_pro_tpu.utils.torch_import import load_torch_state_dict

    fx = load_fixture("model_yolov8n.npz")
    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(load_torch_state_dict_file(f"{FIXTURES}/model_yolov8n.npz"))
    assert model.stride.tolist() == fx["stride"].tolist()

    jm = JModel("yolov8n.yaml")
    variables = load_torch_state_dict(jm.init_params(imgsz=64),
                                      {k[4:]: v for k, v in fx.items() if k.startswith("sd::")})
    ref, _ = jm.apply(variables, jnp.asarray(fx["input"].transpose(0, 2, 3, 1)), train=False)
    ref = np.asarray(ref)
    with torch.no_grad():
        got, raw = model(torch.from_numpy(fx["input"]))
    got = got.numpy()
    assert got.shape == ref.shape == (1, 84, 84)
    assert [tuple(r.shape) for r in raw] == [(1, 144, 8, 8), (1, 144, 4, 4), (1, 144, 2, 2)]
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=1e-5, rtol=0)
    # and against the reference's own recorded output, at test_model_parity's tolerance
    np.testing.assert_allclose(got.transpose(0, 2, 1)[:, :4], fx["output"][:, :4], atol=5e-2, rtol=1e-3)
    np.testing.assert_allclose(got.transpose(0, 2, 1)[:, 4:], fx["output"][:, 4:], atol=2e-3, rtol=1e-3)


def test_predict_slice_matches_jax():
    from ultralytics_pro_tpu import YOLO as JYOLO

    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
            rng.integers(0, 256, (128, 80, 3), dtype=np.uint8)]
    jy = JYOLO("yolov8n.yaml")
    variables = randomize(jy.model.init_params(imgsz=128), seed=11)
    head = variables["params"]["layers_22"]
    for i in range(3):  # peaked DFL bins, so box sizes vary instead of all ~15 strides
        b = head[f"cv2_{i}_2"]["bias"]
        head[f"cv2_{i}_2"]["bias"] = rng.normal(0, 3, b.shape).astype(np.float32)
    jy.model.variables = variables
    ty = YOLO("yolov8n.yaml", device="cpu")
    ty.model.load_state_dict(jax_to_torch_state_dict(variables))

    kw = dict(imgsz=128, conf=0.3, iou=0.5)
    ref = jy.predict(imgs, **kw)
    got = ty.predict(imgs, **kw)
    assert len(got) == len(ref) == 2
    for g, r, im in zip(got, ref, imgs):
        assert g.orig_shape == r.orig_shape == im.shape[:2]
        gd, rd = g.boxes.data, np.asarray(r.boxes.data)
        assert 5 < len(gd) == len(rd) <= 300
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """YOLO defaults to device='cuda' and raises without a card instead of
    running on the CPU; device='cpu' runs there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="cuda"):
        YOLO("yolov8n.yaml")
    m = YOLO("yolov8n.yaml", device="cpu")
    assert next(m.model.parameters()).device.type == "cpu"


def test_unported_modules_raise_by_name():
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load

    d = yaml_model_load("yolov8n.yaml")
    d["backbone"][2] = [-1, 1, "CSPStage", [128]]
    with pytest.raises(NotImplementedError, match="CSPStage"):
        DetectionModel(d)
    with pytest.raises(FileNotFoundError, match="bgf-yolo"):
        DetectionModel("bgf-yolo.yaml")


def test_yaml_activation_override_is_model_wide_and_restored():
    """`activation:` in a model YAML sets every Conv's activation for that
    model only (ultralytics_pro_tpu/nn/modules/conv.py:102-128)."""
    from ultralytics_pro_tpu_torch.nn.modules import Conv
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load

    d = yaml_model_load("yolov8n.yaml")
    d["activation"] = "nn.ReLU()"
    relu = DetectionModel(d)
    acts = {type(m.act).__name__ for m in relu.modules() if isinstance(m, Conv)}
    assert acts == {"ReLU"}
    plain = DetectionModel("yolov8n.yaml")
    assert {type(m.act).__name__ for m in plain.modules() if isinstance(m, Conv)} == {"SiLU"}
