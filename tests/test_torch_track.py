"""The port's trackers against the JAX package's, and the numpy copies of
BoT-SORT's OpenCV calls against OpenCV 5.0.0, on the CPU.

- `trackers/kalman_filter.py` and `trackers/matching.py` against the JAX
  modules on seeded inputs: equal bit for bit (the Hungarian step on costs
  with ties too).
- ByteTrack and BoT-SORT (without frames, so without GMC; with panned frames,
  so with GMC; with ReID through each package's `embed` on the same
  weights) against the JAX trackers on seeded detection sequences (objects
  moving, missed, low-confidence, spurious): ids equal every frame, boxes
  within 1e-6 px without GMC. With GMC the JAX tracker warps by cv2's
  affine and the port by its copy's, which differ by up to 1.1e-6 (cv2's
  10 Levenberg-Marquardt steps against their least-squares fixed point,
  `data/flow.py`); the trackers' f32 rows then differ in their last bits:
  measured on 24-frame sequences, by up to 3.1e-5 px (two f32 steps at
  these coordinates), so the bound is GMC_BOX_TOL = 1e-4 px.
- `data/flow.py` against cv2: `corner_min_eig_val` and `pyr_down` bit for
  bit, the Scharr derivatives equal to cv2.Scharr's int16, the corner list
  of `good_features_to_track` equal, `calc_optical_flow_pyr_lk`'s status
  equal and its points within LK_TOL = 1e-3 px (measured: 3.3e-5),
  `estimate_affine_partial_2d`'s inliers equal, its RANSAC model bit for
  bit and its refined matrix within AFFINE_TOL = 1e-4 (measured: 1.1e-6),
  on seeded textured frames with known sub-pixel shifts, rotations and
  outliers and on the fixture images.
- `YOLO.track` against the JAX facade's on the panned fixture frames: the
  trained yolov8n at 160 px, botsort.yaml and bytetrack.yaml, with persist
  (one frame a call) and without (the folder in one call): ids equal every
  frame, boxes within the letterbox gap (0.03 px, ROADMAP.md section 3).
- `model: auto`: the JAX package reads it as a model YAML and raises; the
  port embeds through the tracking model.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from chip_smoke import pan_sequence, parity_yolov8n, tracked
from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import flow, imread
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.trackers import bot_sort as pbot
from ultralytics_pro_tpu_torch.trackers import byte_tracker as pbyte
from ultralytics_pro_tpu_torch.trackers import kalman_filter as pkf
from ultralytics_pro_tpu_torch.trackers import matching as pmatch
from ultralytics_pro_tpu_torch.trackers import track as ptrack
from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

BOX_TOL = 1e-6  # px, trackers without GMC
GMC_BOX_TOL = 1e-4  # px, BoT-SORT with GMC (see the module docstring)
LETTERBOX_TOL = 0.03  # px, YOLO.track against the JAX facade's
LK_TOL = 1e-3  # px
AFFINE_TOL = 1e-4
REF = json.loads((Path(FIXTURES) / "val_parity_ref.json").read_text())


# -- Kalman filters and matching ---------------------------------------------------

@pytest.mark.parametrize("name", ["KalmanFilterXYAH", "KalmanFilterXYWH"])
def test_kalman_filters_equal_jax_bit_for_bit(name):
    from ultralytics_pro_tpu.trackers import kalman_filter as jkf

    rng = np.random.default_rng(0)
    pk, jk = getattr(pkf, name)(), getattr(jkf, name)()
    meas = np.abs(rng.normal(50, 20, (6, 4))) + 1
    for m in meas:
        got, want = pk.initiate(m), jk.initiate(m)
        for step in range(4):
            got, want = pk.predict(*got), jk.predict(*want)
            z = m + rng.normal(0, 2, 4)
            got, want = pk.update(*got, z), jk.update(*want, z)
        for g, w in zip((*got, *pk.project(*got)), (*want, *jk.project(*want))):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(pk.gating_distance(*got, meas), jk.gating_distance(*want, meas))
        np.testing.assert_array_equal(pk.gating_distance(*got, meas, only_position=True, metric="gaussian"),
                                      jk.gating_distance(*want, meas, only_position=True, metric="gaussian"))
    means = np.abs(rng.normal(40, 10, (5, 8))) + 1
    covs = np.stack([np.diag(np.abs(rng.normal(5, 1, 8))) for _ in range(5)])
    for g, w in zip(pk.multi_predict(means, covs), jk.multi_predict(means, covs)):
        np.testing.assert_array_equal(g, w)


def test_matching_equals_jax():
    from ultralytics_pro_tpu.trackers import matching as jmatch

    rng = np.random.default_rng(1)
    a = rng.uniform(0, 100, (7, 2))
    boxes_a = np.concatenate([a, a + rng.uniform(5, 40, (7, 2))], 1).astype(np.float32)
    boxes_b = np.concatenate([boxes_a[:5] + rng.normal(0, 3, (5, 4)), boxes_a[:3]], 0).astype(np.float32)
    np.testing.assert_array_equal(pmatch.iou_distance(list(boxes_a), list(boxes_b)),
                                  jmatch.iou_distance(list(boxes_a), list(boxes_b)))
    assert pmatch.iou_distance([], list(boxes_b)).shape == jmatch.iou_distance([], list(boxes_b)).shape == (0, 8)
    costs = [rng.uniform(0, 1, (6, 9)), np.round(rng.uniform(0, 1, (8, 5)) * 4) / 4, np.zeros((0, 3)), np.ones((4, 4))]
    for c in costs:
        for thresh in (0.3, 0.8):
            got, want = pmatch.linear_assignment(c, thresh), jmatch.linear_assignment(c, thresh)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]

    class Det:
        def __init__(self, score, feat):
            self.score, self.curr_feat, self.smooth_feat = score, feat, feat

    dets = [Det(float(s), rng.normal(size=16)) for s in rng.uniform(0, 1, 5)]
    trks = [Det(0.5, rng.normal(size=16)) for _ in range(4)]
    c = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    np.testing.assert_array_equal(pmatch.fuse_score(c, dets), jmatch.fuse_score(c, dets))
    np.testing.assert_array_equal(pmatch.embedding_distance(trks, dets), jmatch.embedding_distance(trks, dets))


# -- the trackers on seeded sequences ---------------------------------------------------

def detection_sequence(seed: int, frames: int = 24, objects: int = 7, shape=(320, 400), miss: float = 0.1,
                       junk: int = 3):
    """Per frame (boxes (n, 4) xyxy f32, scores (n,) f32, classes (n,) f32):
    objects moving at constant speed with jitter, each missed in a `miss`
    share of frames, scores spread over both association thresholds, and up
    to junk - 1 spurious boxes."""
    rng = np.random.default_rng(seed)
    h, w = shape
    pos = rng.uniform([20, 20], [w - 90, h - 90], (objects, 2))
    vel = rng.normal(0, 2.5, (objects, 2))
    size = rng.uniform(20, 70, (objects, 2))
    cls = rng.integers(0, 3, objects).astype(np.float32)
    seq = []
    for _ in range(frames):
        pos = pos + vel
        boxes = np.concatenate([pos, pos + size], 1) + rng.normal(0, 0.8, (objects, 4))
        scores = rng.uniform(0.05, 0.95, objects)
        keep = rng.uniform(0, 1, objects) >= miss
        k = int(rng.integers(0, junk))
        extra = rng.uniform(0, min(h, w) - 60, (k, 2))
        boxes = np.concatenate([boxes[keep], np.concatenate([extra, extra + 40], 1)])
        scores = np.concatenate([scores[keep], rng.uniform(0.05, 0.5, k)])
        classes = np.concatenate([cls[keep], rng.integers(0, 3, k).astype(np.float32)])
        seq.append((boxes.astype(np.float32), scores.astype(np.float32), classes))
    return seq


def textured_frames(n: int, shape=(320, 400), seed: int = 3):
    """A blurred random scene panned 1.5 px right and 0.5 px down a frame (sub-pixel, by warpAffine)."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (shape[0] + 40, shape[1] + 40, 3), dtype=np.uint8), (7, 7), 2)
    out = []
    for t in range(n):
        m = np.float32([[1, 0, -20 - 1.5 * t], [0, 1, -20 - 0.5 * t]])
        out.append(cv2.warpAffine(base, m, (shape[1], shape[0]), flags=cv2.INTER_LINEAR))
    return out


def run_tracker(tracker, seq, frames=None):
    return [tracker.update(*det, img=None if frames is None else frames[i]) for i, det in enumerate(seq)]


def assert_same_tracks(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g, w)
        if len(g):
            np.testing.assert_array_equal(g[:, 4:], w[:, 4:])  # id, score, cls, detection index
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=tol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bytetrack_equals_jax(seed):
    from ultralytics_pro_tpu.trackers.byte_tracker import BYTETracker

    seq = detection_sequence(seed)
    want = run_tracker(BYTETracker({}), seq)
    got = run_tracker(pbyte.BYTETracker({}), seq)
    assert_same_tracks(got, want, BOX_TOL)
    assert sum(len(w) for w in want) > 50  # the sequences do get tracked


@pytest.mark.parametrize("with_frames", [False, True], ids=["no_gmc", "gmc"])
def test_botsort_equals_jax(with_frames):
    from ultralytics_pro_tpu.trackers.bot_sort import BOTSORT

    seq = detection_sequence(4, frames=12)
    frames = textured_frames(len(seq)) if with_frames else None
    want = run_tracker(BOTSORT({}), seq, frames)
    got = run_tracker(pbot.BOTSORT({}), seq, frames)
    assert_same_tracks(got, want, GMC_BOX_TOL if with_frames else BOX_TOL)


@pytest.fixture(scope="module")
def trained_pair():
    """(port, JAX facade) on the fixture's trained yolov8n."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    port = parity_yolov8n(YOLO, yaml_model_load, REF, "cpu")
    jax_yolo = JYOLO({**jyaml("yolov8n.yaml"), "nc": 3})
    jax_yolo.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return port, jax_yolo


def test_reid_embeds_as_jax(trained_pair):
    """ReID's per-crop features (crops clipped to the frame, one degenerate)
    through each package's embed at 128 px, within 1e-5."""
    from ultralytics_pro_tpu.trackers.bot_sort import ReID as JReID

    port, jax_yolo = trained_pair
    img = imread(Path(FIXTURES) / "torch_val_synth" / "images" / "val" / "val1.png")
    dets = np.array([[40, 50, 30, 44], [5, 5, 20, 20], [100, 140, 60, 60], [80, 80, 0.4, 0.4]], np.float32)
    got, want = pbot.ReID(port)(img, dets), JReID(jax_yolo)(img, dets)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5, rtol=0)


def test_botsort_with_reid_equals_jax(trained_pair):
    """BoT-SORT with_reid on the panned fixture frames and seeded detections,
    appearance from the same weights through each package's ReID."""
    from ultralytics_pro_tpu.trackers.bot_sort import BOTSORT, ReID as JReID

    port, jax_yolo = trained_pair
    seq = detection_sequence(5, frames=8, objects=4, shape=(160, 160), miss=0.0, junk=1)  # one crop count: one JAX compile
    frames = [imread(Path(FIXTURES) / "torch_val_synth" / "images" / "val" / "val0.png")] * len(seq)
    args = {"with_reid": True, "gmc_method": "none"}
    want = run_tracker(BOTSORT(args, encoder=JReID(jax_yolo)), seq, frames)
    got = run_tracker(pbot.BOTSORT(args, encoder=pbot.ReID(port)), seq, frames)
    assert_same_tracks(got, want, BOX_TOL)


def test_model_auto_embeds_through_the_tracking_model(trained_pair):
    """`model: auto` (botsort.yaml's default): the JAX package builds YOLO("auto")
    and raises; the port's encoder is the tracking model itself."""
    from ultralytics_pro_tpu.trackers.track import make_tracker as jmake

    port, _ = trained_pair
    with pytest.raises(FileNotFoundError, match="auto"):
        jmake("botsort.yaml", args={"with_reid": True})
    tracker = ptrack.make_tracker("botsort.yaml", args={"with_reid": True}, model=port)
    assert tracker.with_reid and tracker.encoder.model is port
    with pytest.raises(ValueError, match="auto"):
        ptrack.make_tracker("botsort.yaml", args={"with_reid": True})


def test_tracker_yaml_copies_and_custom_file(tmp_path):
    from ultralytics_pro_tpu.utils import yaml_load

    for name in ("botsort", "bytetrack"):
        jax_cfg = yaml_load(Path(__file__).resolve().parents[1] / "ultralytics_pro_tpu" / "cfg" / "trackers"
                            / f"{name}.yaml")
        assert ptrack.tracker_settings(f"{name}.yaml") == jax_cfg
    custom = tmp_path / "bytetrack.yaml"  # a file of the tracker's name, as the JAX package reads one
    custom.write_text("tracker_type: bytetrack\ntrack_high_thresh: 0.0\n")
    t = ptrack.make_tracker(str(custom))
    assert isinstance(t, pbyte.BYTETracker) and t.track_high_thresh == 0.0 and t.match_thresh == 0.8
    with pytest.raises(ValueError, match="unknown tracker"):
        ptrack.make_tracker("deepsort.yaml")


# -- the OpenCV copies ----------------------------------------------------------------

def gray(img):
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def flow_pairs():
    """(prev, next) grey frames: blurred random scenes shifted by sub-pixel
    amounts, rotated and scaled, one with an odd size, and the fixture images
    shifted; their names."""
    rng = np.random.default_rng(7)
    out = []
    for i, (h, w, dx, dy, ang, sc) in enumerate([(320, 320, 2.37, 1.61, 0, 1), (240, 320, -4.2, 3.3, 0, 1),
                                                 (301, 257, 0.4, -0.9, 1.5, 1.02), (90, 117, 0.4, 0.9, 0, 1)]):
        base = cv2.GaussianBlur(rng.integers(0, 256, (h, w), dtype=np.uint8), (7, 7), 2)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, sc)
        m[:, 2] += (dx, dy)
        out.append((f"textured{i}", base, cv2.warpAffine(base, m, (w, h), flags=cv2.INTER_LINEAR,
                                                         borderMode=cv2.BORDER_REFLECT)))
    for name in ("val0", "val2", "val3"):
        base = gray(imread(Path(FIXTURES) / "torch_val_synth" / "images" / "val" / f"{name}.png"))
        m = np.float32([[1, 0, 1.3], [0, 1, -0.7]])
        out.append((name, base, cv2.warpAffine(base, m, base.shape[::-1], flags=cv2.INTER_LINEAR,
                                               borderMode=cv2.BORDER_REFLECT)))
    return out


FLOW_PAIRS = flow_pairs()


@pytest.mark.parametrize("case", range(len(FLOW_PAIRS)), ids=[p[0] for p in FLOW_PAIRS])
def test_corners_and_pyramid_equal_cv2(case):
    _, prev, _ = FLOW_PAIRS[case]
    np.testing.assert_array_equal(flow.corner_min_eig_val(prev), cv2.cornerMinEigenVal(prev, 3, 3))
    want = cv2.goodFeaturesToTrack(prev, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
                                   useHarrisDetector=False, k=0.04)
    np.testing.assert_array_equal(flow.good_features_to_track(prev), want)
    np.testing.assert_array_equal(flow.good_features_to_track(prev, max_corners=20, min_distance=7),
                                  cv2.goodFeaturesToTrack(prev, 20, 0.01, 7, blockSize=3))
    np.testing.assert_array_equal(flow.pyr_down(prev), cv2.pyrDown(prev))
    ix, iy = flow.scharr_deriv(prev)
    np.testing.assert_array_equal(ix, cv2.Scharr(prev, cv2.CV_16S, 1, 0))
    np.testing.assert_array_equal(iy, cv2.Scharr(prev, cv2.CV_16S, 0, 1))


def test_no_corners_on_a_flat_image():
    flat = np.full((40, 50), 90, np.uint8)
    assert flow.good_features_to_track(flat) is None
    assert cv2.goodFeaturesToTrack(flat, 1000, 0.01, 1, blockSize=3) is None


@pytest.mark.parametrize("case", range(len(FLOW_PAIRS)), ids=[p[0] for p in FLOW_PAIRS])
def test_optical_flow_and_affine_match_cv2(case):
    _, prev, nxt = FLOW_PAIRS[case]
    pts = cv2.goodFeaturesToTrack(prev, 1000, 0.01, 1, blockSize=3)
    pts = np.concatenate([pts, np.float32([[[-30, 5]], [[prev.shape[1] + 40.5, 8]]])])  # two outside the image
    want, wst, werr = cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)
    got, gst, gerr = flow.calc_optical_flow_pyr_lk(prev, nxt, pts)
    np.testing.assert_array_equal(gst, wst)
    ok = wst.ravel() == 1
    assert ok.sum() > 10 and not ok[-2:].any()
    np.testing.assert_allclose(got[ok], want[ok], atol=LK_TOL, rtol=0)
    np.testing.assert_allclose(gerr[ok], werr[ok], atol=1e-3, rtol=0)
    for m in (got, want):
        assert np.isfinite(m[ok]).all()
    # the affine of the flow's inliers, with a fifth of the points made outliers
    src, dst = pts[ok].copy(), want[ok].copy()
    dst[::5] += np.float32([17.0, -11.0])
    W, wi = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    G, gi = flow.estimate_affine_partial_2d(src, dst)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(G, W, atol=AFFINE_TOL, rtol=0)
    W0, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC, refineIters=0)
    np.testing.assert_array_equal(flow.estimate_affine_partial_2d(src, dst, refine_iters=0)[0], W0)


@pytest.mark.parametrize("seed", range(6))
def test_affine_ransac_equals_cv2_on_seeded_points(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 700))
    f = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    a = rng.uniform(-0.05, 0.05)
    r = rng.uniform(0.95, 1.05) * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    t = (f @ r.T + rng.uniform(-5, 5, 2) + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
    out = rng.uniform(0, 1, n) < 0.3
    t[out] += rng.uniform(-30, 30, (int(out.sum()), 2)).astype(np.float32)
    W, wi = cv2.estimateAffinePartial2D(f, t, method=cv2.RANSAC)
    G, gi = flow.estimate_affine_partial_2d(f, t)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(G, W, atol=AFFINE_TOL, rtol=0)


def test_gmc_matches_the_jax_gmc():
    """GMC through the copies against the JAX GMC through cv2, frame by frame."""
    from ultralytics_pro_tpu.trackers.bot_sort import GMC as JGMC

    frames = textured_frames(5)
    pg, jg = pbot.GMC(), JGMC()
    for f in frames:
        np.testing.assert_allclose(pg.apply(f), jg.apply(f), atol=2 * AFFINE_TOL, rtol=0)


# -- YOLO.track against the JAX facade ----------------------------------------------

@pytest.fixture(scope="module")
def pan_folder(tmp_path_factory):
    return pan_sequence(tmp_path_factory.mktemp("track") / "pan", 10)


@pytest.mark.parametrize("persist", [False, True], ids=["folder", "persist"])
@pytest.mark.parametrize("tracker", ["botsort.yaml", "bytetrack.yaml"])
def test_yolo_track_matches_jax(trained_pair, pan_folder, tracker, persist):
    port, jax_yolo = trained_pair
    files = sorted(pan_folder.glob("*.png"))
    if persist:
        got = [port.track(str(f), imgsz=160, tracker=tracker, persist=True)[0] for f in files]
        want = [jax_yolo.track(str(f), imgsz=160, tracker=tracker, persist=True)[0] for f in files]
    else:
        got = port.track(str(pan_folder), imgsz=160, tracker=tracker)
        want = jax_yolo.track(str(pan_folder), imgsz=160, tracker=tracker)
    assert [r.path for r in got] == [str(f) for f in files] == [r.path for r in want]
    ids, boxes = tracked(got)
    want_ids = [np.asarray(r.boxes.data)[:, 4].astype(int).tolist() if np.asarray(r.boxes.data).shape[1] == 7
                else [] for r in want]
    assert ids == want_ids and sum(map(len, ids)) >= 2 * len(files)
    for b, r in zip(boxes, want):
        if len(b):
            np.testing.assert_allclose(b, np.asarray(r.boxes.data)[:, :4], atol=LETTERBOX_TOL, rtol=0)


def test_track_stream_and_persist_semantics(trained_pair, pan_folder):
    """stream=True gives a generator of the same results; without persist a
    call starts a new tracker (ids from 1), with it the ids go on."""
    port, _ = trained_pair
    listed = tracked(port.track(str(pan_folder), imgsz=160))[0]
    gen = port.track(str(pan_folder), imgsz=160, stream=True)
    assert not isinstance(gen, list) and tracked(list(gen))[0] == listed
    first = sorted(pan_folder.glob("*.png"))[0]
    a = port.track(str(first), imgsz=160)[0].boxes.id
    b = port.track(str(first), imgsz=160)[0].boxes.id
    np.testing.assert_array_equal(a, b)
    assert port._tracker.frame_id == 1
    c = port.track(str(first), imgsz=160, persist=True)[0].boxes.id
    np.testing.assert_array_equal(c, a)
    assert port._tracker.frame_id == 2
