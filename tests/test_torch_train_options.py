"""The trainer's `multi_scale` and `remat` and the dataset's `channels`, against the JAX package, on the CPU.

- `multi_scale`: the port's uint8 resize (`engine/trainer.py:resize_u8`,
  antialiased bilinear, truncated) against `jax.image.resize(method=
  "bilinear")` then `astype(jnp.uint8)` at every rung of the 64 px ladder
  (32, 64, 96) and from 96 to 64 px, within 1 grey level; then six trainer steps of the fixture
  yolov8n in both packages at imgsz 96 (sizes 96, 64, 64, 64, 64, 128), the
  epoch's losses within `test_torch_train.py`'s 1e-4 relative, the port
  resizing through `jax.image.resize` inside the test (`jax_resize`)
  so both train on the same pixels. The two resizes differ in the last bits
  of f32, and truncation to uint8 turns that into one grey level on many
  values of flat regions (up to a fifth of them from 96 to 64 px, above):
  one such step moves the losses apart past 1e-4. Not at 64: its 32 px
  rung leaves a 1 x 1 P5 map, where train-mode BatchNorm over the batch's 2
  values amplifies the two frameworks' f32 rounding past that bound, on
  equal pixels too.
- `remat`: one step with and without it in the port gives the same loss,
  parameters and BN running statistics (updated once), exactly; the loss
  matches the JAX trainer's `remat=True` step within 1e-4 relative.
- `channels: 1`: the fixture yolov8n's val mAPs on the grey set equal the
  JAX facade's within 1e-4.
- A 10-band set of 64 px PNGs and `.npy` band stacks written here: the
  port's re-stemmed model loads the JAX model's initial variables strictly
  and its forward matches `apply` at 64 px (1e-4 of the largest output);
  one trainer step matches the JAX step (loss 1e-4 relative, parameters
  1e-4 of each tensor's largest magnitude); the bands reach the model in
  their order in the trainer and the validator, a 3-channel batch flipped.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import NC, TRAIN_KW, assert_trees_close, jax_model, port_model, train_both
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.engine.predictor import rgb01
from ultralytics_pro_tpu_torch.engine.trainer import device_images, load_pickle, resize_u8
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

LOSS_REL = 1e-4  # test_torch_train.py's per-epoch loss tolerance
MAP_TOL = 1e-4
BANDS = 10


def subset(root: Path, n: int, src: str = "torch_val_synth", channels=None) -> Path:
    """The first n images of a fixture set with their labels, train = val."""
    s = Path(FIXTURES) / src
    for sub in ("images", "labels"):
        (root / sub / "val").mkdir(parents=True)
    for png in sorted((s / "images" / "val").glob("*.png"))[:n]:
        shutil.copy(png, root / "images" / "val")
        shutil.copy(s / "labels" / "val" / f"{png.stem}.txt", root / "labels" / "val")
    names = "".join(f"  {i}: shape{i}\n" for i in range(NC))
    ch = f"channels: {channels}\n" if channels else ""
    (root / "train.yaml").write_text("train: images/val\nval: images/val\n" + ch + "names:\n" + names)
    return root / "train.yaml"


# -- multi_scale -------------------------------------------------------------------
@pytest.mark.parametrize("src,size,equal_floor", [(64, 32, 1.0), (64, 64, 1.0), (64, 96, 0.999), (96, 64, 0.8)])
def test_multi_scale_resize_matches_jax_image_resize(src, size, equal_floor):
    """A 16-image fixture batch letterboxed at src, resized to size: every
    value within 1 grey level of jax.image.resize's, and at least
    equal_floor of them equal (the rest truncated from the other side of an
    integer; 96 -> 64 px measured 85.4% equal)."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset

    d = check_det_dataset(str(Path(FIXTURES) / "torch_val_synth" / "data.yaml"))
    img = next(iter(DataLoader(YOLODataset(d["val"], imgsz=src, data=d), batch_size=16, workers=2)))["img"]
    want = np.asarray(jax.image.resize(jnp.asarray(img).astype(jnp.float32), (16, size, size, 3),
                                       method="bilinear").astype(jnp.uint8))
    got = resize_u8(torch.from_numpy(img), size).numpy() if size != src else img
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got == want).mean() >= equal_floor


def jax_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    import jax
    import jax.numpy as jnp

    b, _, _, c = x.shape
    y = jax.image.resize(jnp.asarray(x.numpy()).astype(jnp.float32), (b, size, size, c), method="bilinear")
    return torch.from_numpy(np.asarray(y.astype(jnp.uint8)))


def test_multi_scale_training_matches_jax(tmp_path, monkeypatch):
    """12 images at batch 2 and nbs 2: six optimizer steps, at sizes
    random.Random(ni).choice([64, 96, 128]) = 96, 64, 64, 64, 64, 128."""
    from ultralytics_pro_tpu_torch.engine import trainer as eng_trainer
    from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer

    data = subset(tmp_path / "set", 12)
    sizes = []
    size_of = BaseTrainer.multi_scale_size
    BaseTrainer.multi_scale_size = lambda self, ni: sizes.append(size_of(self, ni)) or sizes[-1]
    monkeypatch.setattr(eng_trainer, "resize_u8", jax_resize)
    try:
        port, jax_yolo = train_both(data, tmp_path, **{**TRAIN_KW, "epochs": 1, "imgsz": 96, "nbs": 2,
                                                       "multi_scale": True})
    finally:
        BaseTrainer.multi_scale_size = size_of
    assert sizes == [96, 64, 64, 64, 64, 128]
    assert port.trainer.opt_steps == jax_yolo.trainer.opt_steps == 6
    (got,), (want,) = port.trainer.loss_history, jax_yolo.trainer.loss_history
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), (k, got, want)


# -- remat -------------------------------------------------------------------------
def test_remat_step_equals_the_plain_step_and_matches_jax(tmp_path):
    """One step of 8 images (batch 8, nbs 8): remat recomputes each layer's
    forward in the backward, with BatchNorm's running statistics updated by
    the first forward alone."""
    data = subset(tmp_path / "set", 8)
    kw = {**TRAIN_KW, "epochs": 1, "batch": 8, "nbs": 8, "save_period": -1}
    runs = {}
    for remat in (False, True):
        m = port_model()
        m.train(data=str(data), project=str(tmp_path / f"port{remat}"), remat=remat, **kw)
        runs[remat] = (m.trainer.loss_history[0], load_pickle(m.trainer.wdir / "last.ckpt"))
    (l0, c0), (l1, c1) = runs[False], runs[True]
    assert l0 == l1
    for key in ("params", "batch_stats", "ema", "momentum_buffer"):
        assert_trees_close(c1[key], c0[key], 0.0, key)
    stats = [np.asarray(v) for v in jax_tree_leaves(c1["batch_stats"])]
    before = [np.asarray(v) for v in jax_tree_leaves(torch_state_dict_to_jax(port_model().model.state_dict())
                                                      ["batch_stats"])]
    assert any((a != b).any() for a, b in zip(stats, before))  # updated, and (above) as often as without remat

    from ultralytics_pro_tpu.nn.modules import conv as jconv

    jax_yolo = jax_model(port_model())
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        jax_yolo.train(data=str(data), project=str(tmp_path / "jax"), device=1, remat=True, **kw)
    finally:
        jconv.BN_FAST_VARIANCE[0] = saved
    want = jax_yolo.trainer.loss_history[0]
    for k in want:
        assert l1[k] == pytest.approx(want[k], rel=LOSS_REL), (k, l1, want)


def jax_tree_leaves(tree):
    for v in tree.values():
        yield from jax_tree_leaves(v) if isinstance(v, dict) else [v]


def test_remat_off_outside_training():
    """remat acts in train mode with gradients only; eval gives the same outputs either way."""
    m = YOLO({**yaml_model_load("yolov8n.yaml"), "nc": NC}, device="cpu").model
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        want = m(x)[0]
        m.remat = True
        got = m(x)[0]
    assert torch.equal(got, want)


# -- channels ----------------------------------------------------------------------
def test_grey_channels_val_matches_jax(tmp_path):
    """channels: 1 reads each image as cv2's BGR2GRAY repeated to 3 channels;
    the 3-channel model stays."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    root = shutil.copytree(Path(FIXTURES) / "torch_val_synth", tmp_path / "set")
    (root / "data.yaml").write_text((root / "data.yaml").read_text() + "channels: 1\n")
    port = port_model()
    got = port.val(data=str(root / "data.yaml"), imgsz=160, batch=8)
    assert port.model.ch == 3
    y = jyaml("yolov8n.yaml")
    y["nc"] = NC
    jm = JYOLO(y)
    jm.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    want = jm.val(data=str(root / "data.yaml"), imgsz=160, batch=8)
    from ultralytics_pro_tpu_torch.data import YOLODataset, check_det_dataset

    d = check_det_dataset(str(root / "data.yaml"))
    im = YOLODataset(d["val"], imgsz=160, data=d)[0]["img"]
    assert (im[..., 0] == im[..., 1]).all() and (im[..., 1] == im[..., 2]).all()
    assert got.box.map50 == pytest.approx(want.box.map50, abs=MAP_TOL)
    assert got.box.map == pytest.approx(want.box.map, abs=MAP_TOL)


@pytest.fixture(scope="module")
def band_set(tmp_path_factory) -> Path:
    """8 images of the detect set at 64 px (so no resize on load), each
    with a 10-band .npy stack: its B, G, R and seven bands made from them,
    none equal to another, so a reversed order shows."""
    root = tmp_path_factory.mktemp("bands") / "set"
    from ultralytics_pro_tpu_torch.data import imgproc
    from ultralytics_pro_tpu_torch.data.image_io import imread

    data = subset(root, 8, channels=BANDS)
    for png in sorted((root / "images" / "val").glob("*.png")):
        im = imgproc.resize_linear(imread(png), (64, 64))
        x = im.astype(np.int64)
        extra = [(x[..., k % 3] * (k + 2) + 17 * k) % 256 for k in range(BANDS - 3)]
        np.save(png.with_suffix(".npy"), np.concatenate([im, np.stack(extra, -1).astype(np.uint8)], -1))
    return data


def test_band_order_reaches_the_model_unflipped():
    img = np.random.RandomState(0).randint(0, 256, (2, 8, 8, BANDS)).astype(np.uint8)
    want = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0
    assert torch.equal(device_images(img, torch.device("cpu")), want)  # the trainer
    assert torch.equal(rgb01(torch.from_numpy(img)), want)  # the predictor and validator
    rgb = device_images(img[..., :3].copy(), torch.device("cpu"))
    assert torch.equal(rgb, want[:, [2, 1, 0]])


def test_ten_band_model_loads_jax_variables_and_matches_apply(band_set):
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JDetectionModel
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    y = jyaml("yolov8n.yaml")
    jm = JDetectionModel(y, nc=NC, ch=BANDS)
    jm.init_params(imgsz=64)
    from ultralytics_pro_tpu_torch.data import check_det_dataset

    port = YOLO({**yaml_model_load("yolov8n.yaml"), "nc": NC}, device="cpu")
    assert port._restem(check_det_dataset(str(band_set)), nc=NC)  # what val and train do first
    assert port.model.ch == BANDS and port.model.model[0].conv.weight.shape[1] == BANDS
    port.load_state_dict(jax_to_torch_state_dict(jm.variables), strict=True)
    x = np.random.RandomState(1).rand(2, 64, 64, BANDS).astype(np.float32)
    want, _ = jm.apply(jm.variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.model(torch.from_numpy(x).permute(0, 3, 1, 2))[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def ten_band_weights() -> dict:
    """The fixture yolov8n's state dict with its stem taking 10 bands: the
    trained 3-band filters, then 7 scaled copies of them. (At random
    initialisation the JAX package's f32 train-mode forward is 2-6e-4 from
    f64 on the fixture images, tests/test_torch_zoo_train.py.)"""
    sd = {k: v.clone() for k, v in port_model().model.state_dict().items()}
    w = sd["model.0.conv.weight"]
    sd["model.0.conv.weight"] = torch.cat([w] + [0.3 * w[:, k % 3:k % 3 + 1] for k in range(BANDS - 3)], 1)
    return sd


def test_ten_band_train_step_matches_jax(band_set, tmp_path):
    """One optimizer step of 8 images on both packages from the same ch = 10
    weights (`ten_band_weights`), then the epoch-end val on the band set
    (no flip on either side)."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.modules import conv as jconv
    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JDetectionModel
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    kw = {**TRAIN_KW, "epochs": 1, "batch": 8, "nbs": 8, "save_period": -1, "val": True, "conf": 0.001}
    port = YOLO({**yaml_model_load("yolov8n.yaml"), "nc": NC}, device="cpu")
    port.model = port._build(port.model.yaml, nc=NC, ch=BANDS)
    port.load_state_dict(ten_band_weights(), strict=True)
    y = jyaml("yolov8n.yaml")
    y["nc"] = NC
    jm = JYOLO(y)
    jm.model = JDetectionModel(y, nc=NC, ch=BANDS)
    jm.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        port.train(data=str(band_set), project=str(tmp_path / "port"), **kw)
        jm.train(data=str(band_set), project=str(tmp_path / "jax"), device=1, **kw)
    finally:
        jconv.BN_FAST_VARIANCE[0] = saved
    assert port.model.ch == BANDS and port.trainer.opt_steps == 1
    (got,), (want,) = port.trainer.loss_history, jm.trainer.loss_history
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), (k, got, want)
    cp, cj = load_pickle(port.trainer.wdir / "last.ckpt"), load_pickle(jm.trainer.wdir / "last.ckpt")
    assert_trees_close(cp["params"], cj["params"], 1e-4, "params")
    assert port.trainer.last_fitness == pytest.approx(jm.trainer.last_fitness, abs=MAP_TOL)


def test_train_restems_a_model_whose_nc_is_the_band_sets(band_set, tmp_path):
    """A 3-channel model already at the band set's nc is re-stemmed all the
    same (the JAX facade re-stems whatever nc is), and trains on the bands."""
    port = YOLO({**yaml_model_load("yolov8n.yaml"), "nc": NC}, device="cpu")
    assert port.model.nc == NC and port.model.ch == 3
    kw = {**TRAIN_KW, "epochs": 1, "batch": 8, "nbs": 8, "save_period": -1, "val": False}
    port.train(data=str(band_set), project=str(tmp_path), **kw)
    assert port.model.ch == BANDS and port.model.model[0].conv.weight.shape[1] == BANDS
    assert port.trainer.opt_steps == 1
    assert all(np.isfinite(v) for v in port.trainer.loss_history[0].values())
