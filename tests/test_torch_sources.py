"""Predict sources, `predict_files`, `embed`, the facade's `names`, `info` and
`save`, and the Results' exports, against the JAX package on the CPU.

- The loader lists a folder, a glob (recursive too), a file and a list in
  the JAX loader's order; `predict` of a folder, a glob and a list of paths
  gives what `predict` of the decoded arrays gives, each Results' path the
  file's; video files, streams, webcams, screens and YouTube raise
  NotImplementedError naming the missing decoder.
- `predict_files` at batch 16 (the last batch padded) against per-image
  predict (chip_smoke.files_match_predict: counts equal, boxes within 1e-3
  px), and against the JAX `predict_files` (its native C++ loader): counts
  and classes equal, boxes within JAX_FILES_TOL where no resize is needed
  and JAX_RESIZED_TOL (the letterbox gap, as the TTA tests hold it) where
  the letterbox shrinks the image, but for the one named detection whose
  NMS winner differs (JAX_SHRINK_OUTLIER: class equal, IoU at least
  JAX_SHRINK_OUTLIER_IOU); the port's `orig_img` is the decoded file.
- `save_txt` (with and without conf), `summary` (pixels and normalised) and
  `to_json` byte for byte against the JAX Results on the same untracked
  rows, and on classify probabilities; on a tracked row the JAX summary
  reads the track id as the confidence and the confidence as the class
  (`row[:6]`), the port the row's own conf and cls with its track_id.
- `Masks.xy` and `xyn` against the JAX properties (cv2.findContours and
  contourArea) on the segment fixture's instance masks and on seeded blobs
  with holes, touching the border and single pixels, point for point; the
  contour copy against cv2 on each mask, every contour.
- `embed` of arrays and of paths within 1e-5 of the JAX `embed`; `info`
  equal to the JAX model's count; `save` read back by both facades.
"""

import json
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from chip_smoke import files_match_predict, files_set, parity_yolov8n
from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import imread, imwrite
from ultralytics_pro_tpu_torch.data.contours import contour_area, find_contours
from ultralytics_pro_tpu_torch.data.loaders import LoadImagesAndVideos, load_inference_source
from ultralytics_pro_tpu_torch.engine.results import Masks, Results
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

VAL = Path(FIXTURES) / "torch_val_synth" / "images" / "val"
REF = json.loads((Path(FIXTURES) / "val_parity_ref.json").read_text())
JAX_FILES_TOL = 1e-4  # px, predict_files against the JAX one on files that need no resize (measured: 1.5e-5)
JAX_RESIZED_TOL = 0.05  # px, on the 200-px-high files shrunk to 160 (measured: 0.0203; the TTA letterbox gap)
JAX_SHRINK_OUTLIER = ("val15", 0)  # (file stem, row): another anchor wins the NMS there (measured: 2.96 px)
JAX_SHRINK_OUTLIER_IOU = 0.85  # that row's box against the JAX one (measured: 0.889; conf within 1e-4)


@pytest.fixture(scope="module")
def pair():
    """(port, JAX facade) on the fixture's trained yolov8n."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    port = parity_yolov8n(YOLO, yaml_model_load, REF, "cpu")
    jax_yolo = JYOLO({**jyaml("yolov8n.yaml"), "nc": 3})
    jax_yolo.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return port, jax_yolo


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A folder of fixture PNGs (one with an upper-case suffix), a JPEG, a
    text file and a sub-folder."""
    root = tmp_path_factory.mktemp("sources") / "imgs"
    (root / "sub").mkdir(parents=True)
    for i, name in enumerate(["b.png", "a.png", "C.PNG", "sub/d.png"]):
        shutil.copy(VAL / f"val{i}.png", root / name)
    cv2.imwrite(str(root / "e.jpg"), imread(VAL / "val4.png"))
    (root / "notes.txt").write_text("not an image")
    return root


# -- sources ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["folder", "glob", "recursive_glob", "file", "list"])
def test_loader_order_equals_jax(tree, kind):
    from ultralytics_pro_tpu.data.loaders import LoadImagesAndVideos as JLoad

    src = {"folder": str(tree), "glob": str(tree / "*.png"), "recursive_glob": str(tree / "**" / "*.png"),
           "file": str(tree / "a.png"), "list": [str(tree / "b.png"), str(tree / "sub"), tree / "e.jpg"]}[kind]
    got, want = LoadImagesAndVideos(src), JLoad(src)
    assert got.files == want.files and len(got.files)
    for (gp, gim), (wp, wim) in zip(got, want):
        assert gp == wp
        if not gp.endswith(".jpg"):  # PIL's JPEG decoder against cv2's may differ by a level
            np.testing.assert_array_equal(gim, wim)


def test_predict_of_files_equals_predict_of_arrays(pair, tree):
    port, _ = pair
    files = sorted(str(p) for p in tree.glob("*.png"))
    want = port.predict([imread(f) for f in files], imgsz=160)
    for src in (str(tree / "*.png"), files, [Path(f) for f in files]):
        got = port.predict(src, imgsz=160)
        assert [r.path for r in got] == files
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
            np.testing.assert_array_equal(g.orig_img, w.orig_img)
    folder = port.predict(str(tree), imgsz=160)
    assert [Path(r.path).name for r in folder] == ["C.PNG", "a.png", "b.png", "e.jpg"]
    assert [r.path for r in port.predict(str(tree / "a.png"), imgsz=160)] == [str(tree / "a.png")]
    assert list(port.predict([], imgsz=160)) == []


@pytest.mark.parametrize("source", ["clip.mp4", "rtsp://camera/stream", "http://host/video.m3u8", "0",
                                    "screen 1", "https://www.youtube.com/watch?v=x"])
def test_video_and_stream_sources_raise_by_name(pair, tmp_path, source):
    port, _ = pair
    if source.endswith(".mp4"):
        (tmp_path / source).write_bytes(b"\x00" * 16)
        imwrite(tmp_path / "frame.png", np.zeros((8, 8, 3), np.uint8))
        source = str(tmp_path)
    with pytest.raises(NotImplementedError, match="decoder|mss|yt_dlp"):
        port.predict(source, imgsz=160)
    with pytest.raises(FileNotFoundError):
        load_inference_source(str(tmp_path / "missing.png"))


def test_pil_images_are_read_as_bgr(pair):
    from PIL import Image

    port, _ = pair
    img = imread(VAL / "val1.png")
    got = port.predict(Image.fromarray(img[..., ::-1].copy()), imgsz=160)[0]
    want = port.predict(img, imgsz=160)[0]
    np.testing.assert_array_equal(got.boxes.data, want.boxes.data)


def test_predict_files_matches_predict_and_jax(pair, tmp_path):
    """Each of the 16 fixture images once, 8 of them twice: two batches, the
    second padded. The JAX package shrinks the 200-px-high images with cv2,
    the port with its bilinear resize (within a grey level): their boxes are
    held to JAX_RESIZED_TOL, the others to JAX_FILES_TOL. On val15 the
    shrink moves one box by 2.96 px against both JAX predict_files and JAX
    predict (another anchor of the object wins the NMS): that row alone is
    held to its class, its confidence and JAX_SHRINK_OUTLIER_IOU."""
    from ultralytics_pro_tpu_torch.utils.metrics import box_iou_np

    port, jax_yolo = pair
    every = files_set(tmp_path / "files")
    files = every[::8] + every[1::8][:8]
    info = files_match_predict(port, files, imgsz=160)
    assert info["detections"] > 40 and info["max_abs_box_err_px"] <= 1e-3
    got = port.predict_files(files, batch=16, imgsz=160)
    want = jax_yolo.predict_files([str(f) for f in files], batch=16, imgsz=160)
    assert [r.path for r in got] == [str(f) for f in files] == [r.path for r in want]
    outliers = 0
    for g, w in zip(got, want):
        wd = np.asarray(w.boxes.data)
        assert len(g.boxes.data) == len(wd)
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        gx, wx = g.boxes.xyxy, wd[:, :4]
        if Path(g.path).stem.split("_")[0] == JAX_SHRINK_OUTLIER[0]:
            row = JAX_SHRINK_OUTLIER[1]
            assert box_iou_np(gx[row:row + 1], wx[row:row + 1])[0, 0] >= JAX_SHRINK_OUTLIER_IOU
            assert abs(g.boxes.conf[row] - wd[row, 4]) <= 1e-4
            gx, wx, outliers = np.delete(gx, row, 0), np.delete(wx, row, 0), outliers + 1
        tol = JAX_RESIZED_TOL if max(g.orig_shape) > 160 else JAX_FILES_TOL
        np.testing.assert_allclose(gx, wx, atol=tol, rtol=0)
        np.testing.assert_array_equal(g.orig_img, imread(g.path))
    assert outliers == 2  # val15 is in both batches


# -- Results exports ----------------------------------------------------------------

def result_pair(data, orig=None, names=None, **kw):
    from ultralytics_pro_tpu.engine.results import Results as JResults

    orig = np.zeros((120, 160, 3), np.uint8) if orig is None else orig
    names = names or {0: "a", 1: "b", 2: "c"}
    return Results(orig, "x.png", names, **{k: data for k in kw}), JResults(orig, "x.png", names, **{k: data for k in kw})


def test_exports_equal_jax_byte_for_byte(pair, tmp_path):
    port, _ = pair
    for i in range(4):
        data = port.predict(imread(VAL / f"val{i}.png"), imgsz=160, conf=0.05)[0].boxes.data
        got, want = result_pair(data, boxes=True)
        assert len(data)
        for save_conf in (False, True):
            gp, wp = tmp_path / f"g{i}{save_conf}.txt", tmp_path / f"w{i}{save_conf}.txt"
            got.save_txt(gp, save_conf=save_conf)
            got.save_txt(gp, save_conf=save_conf)  # appends
            want.save_txt(wp, save_conf=save_conf)
            want.save_txt(wp, save_conf=save_conf)
            assert gp.read_bytes() == wp.read_bytes()
        for normalize in (False, True):
            assert got.summary(normalize=normalize) == want.summary(normalize=normalize)
            assert got.to_json(normalize=normalize, decimals=3) == want.to_json(normalize=normalize, decimals=3)
    probs = np.random.default_rng(0).dirichlet(np.ones(7)).astype(np.float32)
    got, want = result_pair(probs, names={i: f"n{i}" for i in range(7)}, probs=True)
    got.save_txt(tmp_path / "gp.txt")
    want.save_txt(tmp_path / "wp.txt")
    assert (tmp_path / "gp.txt").read_bytes() == (tmp_path / "wp.txt").read_bytes()
    assert got.summary() == want.summary() and got.to_json() == want.to_json()
    empty, jempty = result_pair(np.zeros((0, 6), np.float32), boxes=True)
    empty.save_txt(tmp_path / "ge.txt")
    jempty.save_txt(tmp_path / "we.txt")
    assert (tmp_path / "ge.txt").read_bytes() == (tmp_path / "we.txt").read_bytes() == b""
    assert empty.summary() == jempty.summary() == [] and len(empty.new()) == 0 and empty.new().path == "x.png"


def test_tracked_summary_reads_conf_and_cls_where_jax_reads_the_id(monkeypatch):
    row = np.array([[10, 20, 50, 60, 7, 0.875, 2]], np.float32)  # xyxy, id 7, conf 0.875, cls 2
    got, want = result_pair(row, boxes=True)
    assert got.boxes.is_track and got.boxes.id.tolist() == [7] and want.boxes.id.tolist() == [7]
    g, w = got.summary()[0], want.summary()[0]
    assert (g["confidence"], g["class"], g["name"], g["track_id"]) == (0.875, 2, "c", 7)
    assert (w["confidence"], w["class"]) == (7.0, 0) and "track_id" not in w  # JAX: row[:6] takes the id as conf
    assert result_pair(row[:, [0, 1, 2, 3, 5, 6]], boxes=True)[0].boxes.id is None
    assert len(got.to_df()) == 1  # a DataFrame where pandas is installed
    monkeypatch.setitem(sys.modules, "pandas", None)  # pandas absent: the list of dicts
    assert got.to_df() == got.summary()


def seeded_masks():
    """Blobs with holes, touching every border, single pixels and diagonal
    chains; and the segment fixture's instance masks (its polygons filled)."""
    rng = np.random.default_rng(0)
    masks = []
    for i in range(12):
        m = np.zeros((48, 64), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            c = (int(rng.integers(-5, 70)), int(rng.integers(-5, 53)))
            cv2.circle(m, c, int(rng.integers(2, 16)), 1, -1)
            cv2.circle(m, c, int(rng.integers(0, 5)), 0, -1)
        m[rng.integers(0, 48, 3), rng.integers(0, 64, 3)] = 1
        if i % 3 == 0:
            m |= (rng.uniform(0, 1, m.shape) < 0.08).astype(np.uint8)
        masks.append(m)
    masks.append(np.eye(48, 64, dtype=np.uint8))
    masks.append(np.zeros((48, 64), np.uint8))
    masks.append(np.ones((48, 64), np.uint8))
    root = Path(FIXTURES) / "torch_val_synth_segment"
    for lbl in sorted((root / "labels" / "val").glob("*.txt"))[:4]:
        img = imread(root / "images" / "val" / f"{lbl.stem}.png")
        h, w = img.shape[:2]
        for line in lbl.read_text().splitlines():
            pts = np.array(line.split()[1:], np.float64).reshape(-1, 2) * (w, h)
            m = np.zeros((h, w), np.uint8)
            cv2.fillPoly(m, [pts.round().astype(np.int32)], 1)
            masks.append(m)
    return masks


def test_masks_xy_equal_jax_and_contours_equal_cv2():
    from ultralytics_pro_tpu.engine.results import Masks as JMasks

    masks = seeded_masks()
    for m in masks:
        want = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = find_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert contour_area(g) == cv2.contourArea(w)
    for shape in {m.shape for m in masks}:
        group = np.stack([m for m in masks if m.shape == shape]).astype(bool)
        got, want = Masks(group, shape), JMasks(group, shape)
        for g, w in zip(got.xy, want.xy):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got.xyn, want.xyn):
            np.testing.assert_array_equal(g, w)


# -- embed, info, save --------------------------------------------------------------

def test_embed_matches_jax(pair):
    port, jax_yolo = pair
    imgs = [imread(VAL / f"val{i}.png") for i in range(3)]
    want = jax_yolo.embed(imgs, imgsz=96)
    got = port.embed(imgs, imgsz=96)
    assert got.shape == want.shape and got.shape[0] == 3 and got.ndim == 2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    # paths, and one image alone (other batch sizes: the CPU's convolutions round apart in the last bits)
    np.testing.assert_allclose(port.embed([str(VAL / "val0.png"), VAL / "val1.png"], imgsz=96), got[:2], atol=1e-6)
    np.testing.assert_allclose(port.embed(imgs[2], imgsz=96), got[2:], atol=1e-6)


def test_names_info_and_save_round_trip(pair, tmp_path):
    from ultralytics_pro_tpu import YOLO as JYOLO

    port, jax_yolo = pair
    assert port.names == port.model.names
    assert port.info(verbose=False) == jax_yolo.info(verbose=False)
    path = port.save(tmp_path / "saved.ckpt")
    img = imread(VAL / "val2.png")
    want = port.predict(img, imgsz=160)[0].boxes.data
    np.testing.assert_array_equal(YOLO(str(path), device="cpu").predict(img, imgsz=160)[0].boxes.data, want)
    jax_boxes = np.asarray(JYOLO(str(path)).predict(img, imgsz=160)[0].boxes.data)
    np.testing.assert_allclose(jax_boxes[:, :4], want[:, :4], atol=0.03, rtol=0)
