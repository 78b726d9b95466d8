"""The port on a CUDA card: kernels K1 and K2 against their plain versions,
and predict (yolov8n, and rtdetr-l through K2).

These tests need a card and nvcc, and import neither JAX nor the JAX package
nor `tests/conftest.py` (which imports JAX), so they run on a machine that has
the card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card they skip. `k1_inputs` also feeds the CPU tests of
test_torch_nms.py.
"""

import numpy as np
import pytest
import torch

from ultralytics_pro_tpu_torch import RTDETR, YOLO
from ultralytics_pro_tpu_torch.kernels import msda_cuda, nms_cuda


def k1_inputs(seed, b=5, k=256):
    """Seeded boxes with class offsets and scores; with b >= 4 the first rows
    hold the hard cases: an all -1 row, a row that runs out after at most 3
    picks, duplicate scores, and a row whose live scores are all equal."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    cls = rng.integers(0, 3, (b, k, 1)) * 7680.0
    boxes = (np.concatenate([xy, xy + wh], -1) + cls).astype(np.float32)
    scores = np.where(rng.uniform(0, 1, (b, k)) > 0.3, rng.uniform(0, 1, (b, k)), -1.0)
    if b >= 4:
        scores[0] = -1.0
        scores[1] = -1.0
        scores[1, [7, k // 2, k - 1]] = [0.9, 0.5, 0.5]
        scores[2] = np.where(scores[2] > 0, np.ceil(scores[2] * 8) / 8, -1.0)  # many ties
        scores[3] = np.where(scores[3] > 0, 0.25, -1.0)  # every live score equal
    return boxes, scores.astype(np.float32)


@pytest.mark.cuda
def test_k1_kernel_equals_plain_on_card():
    """The CUDA kernel against its plain version, bit for bit (card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed, k in ((0, 8400), (1, 30000)):
        boxes, scores = k1_inputs(seed, b=4, k=k)
        bc, sc = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        before = nms_cuda.launches
        keep, valid = nms_cuda.greedy_nms(bc, sc, 300, 0.7)
        assert nms_cuda.launches == before + 1
        rk, rv = nms_cuda.greedy_nms_plain(bc, sc, 300, 0.7)
        assert torch.equal(keep, rk) and torch.equal(valid, rv)


@pytest.mark.cuda
def test_k1_refuses_k_beyond_shared_memory():
    """A K whose scores do not fit one block's shared memory (227 KB on an
    H100) raises before any launch; there is no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, scores = k1_inputs(0, b=1, k=60000)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        nms_cuda.greedy_nms(torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda(), 300, 0.7)
    assert nms_cuda.launches == before


@pytest.mark.cuda
def test_predict_on_card_launches_k1_per_image():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    imgs = [np.random.default_rng(i).integers(0, 256, (48, 64, 3), dtype=np.uint8) for i in range(3)]
    m = YOLO("yolov8n.yaml", device="cuda")
    before = nms_cuda.launches
    res = m.predict(imgs, imgsz=64, conf=1e-6)
    assert nms_cuda.launches == before + len(imgs)
    assert all(0 < len(r) <= 300 for r in res)


def k2_inputs(seed, b=2, q=37, nh=4, hd=8, shapes=((12, 16), (6, 8), (3, 4)), p=4, out_of_range=False):
    """The value table (B, nh, V, hd), flat corner rows and weights of
    tests/test_msda_kernel.py's `_problem` (locations in [-0.1, 1.1], so
    corners fall outside), made with numpy and the port's
    msda_flatten_coords. With out_of_range, a fifth of the rows are moved
    outside [0, V) and every weight is positive, so skipped rows would show."""
    rng = np.random.default_rng(seed)
    v = sum(h * w for h, w in shapes)
    val = torch.from_numpy(rng.normal(size=(b, nh, v, hd)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, q, nh, len(shapes), p, 2)).astype(np.float32))
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    attn = torch.from_numpy(attn / attn.sum((-1, -2), keepdims=True))
    idx, w = msda_cuda.msda_flatten_coords(list(shapes), locs, attn)
    if out_of_range:
        mask = torch.from_numpy(rng.uniform(size=tuple(idx.shape)) < 0.2)
        bad = torch.from_numpy(rng.choice([-1, -7, v, v + 5, 2 ** 30], size=tuple(idx.shape)).astype(np.int32))
        idx, w = torch.where(mask, bad, idx), w + 0.1
    return val, idx.contiguous(), w.contiguous()


RTDETR_L_SHAPES = ((80, 80), (40, 40), (20, 20))  # rtdetr-l's levels at 640 px: V = 8400


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["problem", "problem_out_of_range", "rtdetr_l"])
def test_k2_kernel_matches_plain_on_card(case):
    """K2 against its plain version on the card and on the CPU, at 1e-5
    (f32 sums over 48 corners in another order); out-of-range rows add 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if case == "rtdetr_l":
        val, idx, w = k2_inputs(2, b=1, q=300, nh=8, hd=32, shapes=RTDETR_L_SHAPES)
    else:
        val, idx, w = k2_inputs(1, out_of_range=case.endswith("out_of_range"))
    before = msda_cuda.launches
    out = msda_cuda.msda_sample(val.cuda(), idx.cuda(), w.cuda())
    torch.cuda.synchronize()
    assert msda_cuda.launches == before + 1
    ref_gpu = msda_cuda.msda_sample_plain(val.cuda(), idx.cuda(), w.cuda())
    ref_cpu = msda_cuda.msda_sample_plain(val, idx, w)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref_gpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.cpu(), ref_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k2_refuses_grad_and_wrong_types():
    """No backward and no silent casts: the wrapper raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    val, idx, w = (t.cuda() for t in k2_inputs(3, b=1, q=5))
    before = msda_cuda.launches
    with pytest.raises(RuntimeError, match="backward"):
        msda_cuda.msda_sample(val.clone().requires_grad_(True), idx, w)
    with pytest.raises(TypeError, match="int32"):
        msda_cuda.msda_sample(val, idx.long(), w)
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_sample(val.transpose(2, 3), idx, w)
    assert msda_cuda.launches == before


@pytest.mark.cuda
def test_rtdetr_l_predict_on_card_runs_k2_in_every_decoder_layer():
    """rtdetr-l at full width and depth on the card: 6 K2 launches per image
    (one per decoder layer), none of them from the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    imgs = [np.random.default_rng(i).integers(0, 256, (480, 640, 3), dtype=np.uint8) for i in range(2)]
    m = RTDETR("rtdetr-l.yaml", device="cuda")
    before = msda_cuda.launches
    res = m.predict(imgs)
    assert msda_cuda.launches == before + 6 * len(imgs)
    assert all(0 <= len(r) <= 300 for r in res) and any(len(r) for r in res)
    assert all(np.isfinite(r.boxes.data).all() for r in res)
