"""The port on a CUDA card: kernels K1 and K2 against their plain versions,
predict (yolov8n, and rtdetr-l through K2) in full f32, detect, segment and
pose val on the committed fixture sets against val on the CPU, K1 on
segment and pose rows with their payload, the OBB task's rotated NMS
(plain PyTorch) on the card against the CPU, the segment, pose and OBB
criteria, forward and backward, on the card against the CPU, classify
predict and val and rtdetr-l val (K2 on the val path) against the CPU, K2's
backward kernel against the plain version's autograd, a narrow RT-DETR
training epoch through K2 forward and backward, the YOLO11, YOLOv10, v5
anchor-head, YOLO12, GELAN-DSegment and YOLOv13 (seeded FullPAD gates)
forwards and predicts on the card against the CPU (v10 without NMS), two
attention-zoo models' predict at 640 px against the CPU, K1 on
yolov3-tiny's two-level rows, on the anchor head's 25,200-candidate rows and
on a narrowed yolov7's and yolov7-anchor's (IDetect, the implicit anchor
head), their forwards on the card against the CPU, K1 on yolov8n-att's and
hyper-yolo-n's rows (the plain deformable conv, the hypergraph conv) with
their forwards against the CPU, test-time augmentation and a rect val on the card against the CPU, the
multi_scale resize of an augmented batch (alone and through the trainer's
`device_images`) and one augmented train step on the card against the CPU,
predict_files against per-image predict on the card, and the trackers' ids
on the card against the CPU.

These tests need a card and nvcc, and import neither JAX nor the JAX package
nor `tests/conftest.py` (which imports JAX), so they run on a machine that has
the card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card they skip (the `card` fixture decides, never an import).
`k1_inputs` also feeds the CPU tests of test_torch_nms.py, `task_loss_inputs`
and `port_criterion` those of test_torch_task_loss.py, and the narrow RT-DETR
`NARROW` those of test_torch_rtdetr.py and test_torch_rtdetr_train.py.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    aug_host_batch,
    capture_k1,
    check_detections,
    cls_fixture_model,
    fixture_train_set,
    multi_scale_rungs,
    one_step_diffs,
    parity_yolov8n,
    train_one_step,
    tta_fixture,
    zoo_parity,
    zoo_yolo,
)
from ultralytics_pro_tpu_torch import RTDETR, YOLO
from ultralytics_pro_tpu_torch.kernels import msda_cuda, nms_cuda
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load

FIXTURES = Path(__file__).resolve().parent / "fixtures"

TF32_FLAGS = ("cudnn", "matmul")

# A narrow RT-DETR with rtdetr-l's module set: HGStem, HGBlock plain and with
# LightConv (with and without the residual), DWConv, AIFI, RepC3 (with and
# without cv3) and an RTDETRDecoder of hd = 64 (8 heads of 8), 2 layers and
# the default nq = 300.
NARROW = {
    "nc": 7,
    "backbone": [
        [-1, 1, "HGStem", [8, 16]],  # 0 P2/4
        [-1, 2, "HGBlock", [8, 32, 3]],  # 1
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],  # 2 P3/8
        [-1, 2, "HGBlock", [16, 48, 3]],  # 3
        [-1, 1, "DWConv", [48, 3, 2, 1, False]],  # 4 P4/16
        [-1, 2, "HGBlock", [16, 64, 5, True, False]],  # 5
        [-1, 2, "HGBlock", [16, 64, 5, True, True]],  # 6
        [-1, 1, "DWConv", [64, 3, 2, 1, False]],  # 7 P5/32
        [-1, 2, "HGBlock", [32, 128, 5, True, False]],  # 8
    ],
    "head": [
        [-1, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 9
        [-1, 1, "AIFI", [128, 8]],  # 10
        [-1, 1, "Conv", [64, 1, 1]],  # 11
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [6, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 13
        [[-2, -1], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 15
        [-1, 1, "Conv", [64, 1, 1]],  # 16
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [3, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 18
        [[-2, -1], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 20 X3
        [-1, 1, "Conv", [64, 3, 2]],
        [[-1, 16], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 23 F4
        [-1, 1, "Conv", [64, 3, 2]],
        [[-1, 11], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64, 0.5]],  # 26 F5
        [[20, 23, 26], 1, "RTDETRDecoder", ["nc", 64, 300, 2]],
    ],
}


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set_tf32(flags):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture
def card():
    """Skips the test without a CUDA card; checks that the test left torch's
    TF32 flags as it found them, and restores them either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = _tf32()
    yield
    after = _tf32()
    _set_tf32(before)
    assert after == before, f"TF32 flags {dict(zip(TF32_FLAGS, before))} became {dict(zip(TF32_FLAGS, after))}"


@pytest.fixture
def tf32_on(card):
    """TF32 allowed for convolutions and matmuls, as a caller may leave torch;
    restored after the test."""
    before = _tf32()
    _set_tf32((True, True))
    yield
    _set_tf32(before)


def k1_inputs(seed, b=5, k=256):
    """Seeded boxes with class offsets and scores; with b >= 4 the first rows
    hold the hard cases: an all -1 row, a row that runs out after at most 3
    picks, duplicate scores, and a row whose live scores are all equal; with
    b >= 5 row 4 has a zero-area box at its 20th best score, which does not
    suppress itself and so fills every slot after it."""
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
    if b >= 5:
        j = np.argsort(-scores[4], kind="stable")[19]
        boxes[4, j, 2] = boxes[4, j, 0]  # zero width
    return boxes, scores.astype(np.float32)


LOSS_NC, LOSS_IMGSZ, LOSS_STRIDES = 3, 64, (8, 16, 32)
LOSS_RTOL, LOSS_GRAD_TOL = 1e-5, 1e-4  # loss parts relative; gradients against each tensor's largest


def task_loss_inputs(task: str, seed: int, kpt_shape=(17, 3), b: int = 3, g: int = 6, nm: int = 32,
                     empty: bool = False):
    """Seeded head outputs and a padded batch for a task's criterion at 64 px
    (levels 8, 4 and 2: A = 84 anchors), nc 3, numpy f32. preds: 'feats'
    (per level (B, 64 + nc, h, h), NCHW), and segment's 'mc' (B, A, nm) and
    'protos' (B, nm, 16, 16), pose's 'kpt' (B, A, K * ndim) raw, or obb's
    'angle' (B, A, 1) in [-pi/4, 3pi/4). The batch has unused slots, image 1
    has no object (every image with empty=True), obb's first box is 1.5 px
    wide and centred on an anchor, pose's keypoints have invisible ones (0, 0, 0) and segment's masks
    are 0/1 blobs inside their boxes."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 2, (b, 64 + LOSS_NC, h, h)).astype(np.float32) for h in (8, 4, 2)]
    a = sum(h * h for h in (8, 4, 2))
    mask = rng.uniform(size=(b, g)) < 0.7
    mask[0, 0] = True
    mask[1] = False
    if empty:
        mask[:] = False
    cls = (rng.integers(0, LOSS_NC, (b, g)) * mask).astype(np.float32)
    xywh = np.concatenate([rng.uniform(0.25, 0.75, (b, g, 2)), rng.uniform(0.1, 0.5, (b, g, 2))], -1)
    preds = {"feats": feats}
    batch = {"cls": cls, "mask_gt": mask}
    if task == "obb":
        xywhr = np.concatenate([xywh, rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, g, 1))], -1)
        xywhr[0, 0, :3] = 28 / LOSS_IMGSZ, 28 / LOSS_IMGSZ, 1.5 / LOSS_IMGSZ  # under 2 px, on an anchor
        batch["bboxes"] = (xywhr * mask[..., None]).astype(np.float32)
        logits = rng.normal(0, 1, (b, a, 1))
        preds["angle"] = ((1 / (1 + np.exp(-logits)) - 0.25) * np.pi).astype(np.float32)
        return preds, batch
    batch["bboxes"] = (xywh * mask[..., None]).astype(np.float32)
    if task == "segment":
        preds["mc"] = rng.normal(0, 1, (b, a, nm)).astype(np.float32)
        preds["protos"] = rng.normal(0, 1, (b, nm, 16, 16)).astype(np.float32)
        grid = (np.arange(16) + 0.5) / 16
        lo, hi = (xywh[..., :2] - xywh[..., 2:] / 2)[..., None], (xywh[..., :2] + xywh[..., 2:] / 2)[..., None]
        in_x = (grid > lo[..., 0, :]) & (grid < hi[..., 0, :])  # (B, G, 16) columns
        in_y = (grid > lo[..., 1, :]) & (grid < hi[..., 1, :])  # rows
        inside = in_y[..., :, None] & in_x[..., None, :]
        blobs = inside & (rng.uniform(size=(b, g, 16, 16)) < 0.8) & mask[..., None, None]
        batch["masks"] = blobs.astype(np.float32)
    elif task == "pose":
        k, nd = kpt_shape
        preds["kpt"] = rng.normal(0, 1, (b, a, k * nd)).astype(np.float32)
        xy = xywh[..., None, :2] + (rng.uniform(-0.5, 0.5, (b, g, k, 2)) * xywh[..., None, 2:])
        kp = np.concatenate([xy, rng.integers(0, 3, (b, g, k, 1))], -1) if nd == 3 else xy
        if nd == 3:
            kp[kp[..., 2] == 0] = 0.0  # invisible: (0, 0, 0), as the labels give them
        batch["keypoints"] = (kp * mask[..., None, None]).astype(np.float32)
    return preds, batch


def port_criterion(task: str, kpt_shape=(17, 3), overlap_mask: bool = True, hyp=None):
    """The port's criterion of a task at task_loss_inputs' nc and strides."""
    from ultralytics_pro_tpu_torch.utils import loss

    kw = {"nc": LOSS_NC, "reg_max": 16, "strides": LOSS_STRIDES, "hyp": hyp}
    if task == "segment":
        return loss.v8SegmentationLoss(**kw, overlap_mask=overlap_mask)
    if task == "pose":
        return loss.v8PoseLoss(**kw, kpt_shape=kpt_shape)
    return loss.v8OBBLoss(**kw)


def port_loss_and_grads(criterion, preds, batch, device: str = "cpu"):
    """The criterion's parts and total, and the gradient of the total with
    respect to each head output (feats as a list), on a device; numpy out."""
    from ultralytics_pro_tpu_torch.utils import full_f32

    leaves = {k: ([torch.tensor(f, device=device, requires_grad=True) for f in v] if k == "feats"
                  else torch.tensor(v, device=device, requires_grad=True)) for k, v in preds.items()}
    with full_f32():
        total, parts = criterion(leaves, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                 (LOSS_IMGSZ, LOSS_IMGSZ))
        total.backward()
    grads = {k: ([f.grad.cpu().numpy() for f in v] if k == "feats" else v.grad.cpu().numpy())
             for k, v in leaves.items()}
    return float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}, grads


def assert_grads_close(got: dict, want: dict):
    for k in want:
        for g, w in zip(*((v if k == "feats" else [v]) for v in (got[k], want[k]))):
            np.testing.assert_allclose(g, w, rtol=0, atol=LOSS_GRAD_TOL * max(np.abs(w).max(), 1e-12), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_task_criterion_on_card_matches_cpu(card, task):
    """Each task's criterion on a seeded batch, forward and backward, on the
    card and on the CPU: parts within 1e-5 relative, gradients with respect
    to the head's outputs within 1e-4 of each tensor's largest (the CPU tests'
    tolerances against the JAX criteria)."""
    preds, batch = task_loss_inputs(task, seed=11)
    criterion = port_criterion(task)
    ct, cparts, cgrads = port_loss_and_grads(criterion, preds, batch, "cuda")
    ht, hparts, hgrads = port_loss_and_grads(criterion, preds, batch, "cpu")
    assert cparts.keys() == hparts.keys()
    for k in hparts:
        assert cparts[k] == pytest.approx(hparts[k], rel=LOSS_RTOL), k
    assert ct == pytest.approx(ht, rel=LOSS_RTOL)
    assert_grads_close(cgrads, hgrads)


@pytest.mark.cuda
def test_k1_kernel_equals_plain_on_card(card):
    """The CUDA kernel against its plain version, bit for bit: on rows sorted
    as the main path hands them over (presorted) and on unsorted rows through
    the wrapper's sort and map back, at the predict and val candidate counts,
    with ties and a zero-area box (row 4) among the rows."""
    for seed, k in ((0, 8400), (1, 30000)):
        boxes, scores = k1_inputs(seed, b=6, k=k)
        bc, sc = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        order = torch.sort(sc, dim=1, descending=True, stable=True).indices
        sb = torch.gather(bc, 1, order[..., None].expand(-1, -1, 4))
        ss = torch.gather(sc, 1, order)
        for rows, presorted in (((bc, sc), False), ((sb, ss), True)):
            before = nms_cuda.launches
            keep, valid = nms_cuda.greedy_nms(*rows, 300, 0.7, presorted=presorted)
            torch.cuda.synchronize()
            assert nms_cuda.launches == before + 1
            rk, rv = nms_cuda.greedy_nms_plain(*rows, 300, 0.7)
            assert torch.equal(keep, rk) and torch.equal(valid, rv)
            assert int(valid[4].sum()) == 300  # the zero-area box fills its row


@pytest.mark.cuda
def test_k1_takes_any_k_and_refuses_max_det_beyond_shared_memory(card):
    """Candidates stream through shared memory, so K is not limited by it
    (K = 60000 runs); the keeps sit there, so a max_det whose keeps do not
    fit one block's shared memory (227 KB on an H100) raises before any
    launch; there is no fallback."""
    boxes, scores = k1_inputs(0, b=1, k=60000)
    bc, sc = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
    keep, valid = nms_cuda.greedy_nms(bc, sc, 300, 0.7)
    rk, rv = nms_cuda.greedy_nms_plain(bc, sc, 300, 0.7)
    assert torch.equal(keep, rk) and torch.equal(valid, rv)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        nms_cuda.greedy_nms(bc, sc, 20000, 0.7)
    assert nms_cuda.launches == before


@pytest.mark.cuda
def test_predict_on_card_launches_k1_per_image(card):
    imgs = [np.random.default_rng(i).integers(0, 256, (48, 64, 3), dtype=np.uint8) for i in range(3)]
    m = YOLO("yolov8n.yaml", device="cuda")
    before = nms_cuda.launches
    res = m.predict(imgs, imgsz=64, conf=1e-6)
    assert nms_cuda.launches == before + len(imgs)
    assert all(0 < len(r) <= 300 for r in res)


def k2_inputs(seed, b=2, q=37, nh=4, hd=8, shapes=((12, 16), (6, 8), (3, 4)), p=4, lo=-0.1, hi=1.1):
    """A value table (B, V, nh, hd) as MSDeformAttn makes it, locations
    uniform in [lo, hi] (outside [0, 1] their corners fall outside the maps)
    and attention weights that sum to 1 over each query's points, made with
    numpy."""
    rng = np.random.default_rng(seed)
    v = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.normal(size=(b, v, nh, hd)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(lo, hi, (b, q, nh, len(shapes), p, 2)).astype(np.float32))
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    attn = torch.from_numpy(attn / attn.sum((-1, -2), keepdims=True))
    return value, list(shapes), locs, attn


RTDETR_L_SHAPES = ((80, 80), (40, 40), (20, 20))  # rtdetr-l's levels at 640 px: V = 8400
K2_CASES = {
    "rtdetr_l_predict": dict(b=1, q=300, nh=8, hd=32, shapes=RTDETR_L_SHAPES),
    "rtdetr_l_batch16": dict(b=16, q=300, nh=8, hd=32, shapes=RTDETR_L_SHAPES),
    "edge_hd8_q37_outside": dict(lo=-0.6, hi=1.6),
    "hd40_two_levels": dict(b=1, q=9, nh=3, hd=40, shapes=((5, 7), (3, 4)), p=3, lo=-1.0, hi=2.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_kernel_matches_plain_on_card(card, case):
    """The fused K2 against its plain composition (msda_flatten_coords, then
    msda_sample_plain) on the card and on the CPU, at 1e-5 (f32 sums over
    L*P*4 corners in another order and with fused multiply-adds)."""
    value, shapes, locs, attn = k2_inputs(2, **K2_CASES[case])
    before = msda_cuda.launches
    out = msda_cuda.msda_sample_fused(value.cuda(), shapes, locs.cuda(), attn.cuda())
    torch.cuda.synchronize()
    assert msda_cuda.launches == before + 1
    ref_gpu = msda_cuda.msda_sample_fused_plain(value.cuda(), shapes, locs.cuda(), attn.cuda())
    ref_cpu = msda_cuda.msda_sample_fused_plain(value, shapes, locs, attn)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref_gpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.cpu(), ref_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k2_refuses_grad_and_wrong_types(card):
    """No silent casts or copies: the wrapper raises before a launch. (Grad
    is no longer refused: K2 has a backward kernel, held by
    test_k2_backward_matches_plain_autograd_on_card.)"""
    value, shapes, locs, attn = k2_inputs(3, b=1, q=5)
    value, locs, attn = value.cuda(), locs.cuda(), attn.cuda()
    before = msda_cuda.launches
    with pytest.raises(TypeError, match="float32"):
        msda_cuda.msda_sample_fused(value.double(), shapes, locs, attn)
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_sample_fused(value.transpose(2, 3).contiguous().transpose(2, 3), shapes, locs, attn)
    with pytest.raises(ValueError, match="levels"):
        msda_cuda.msda_sample_fused(value, shapes[:2], locs[:, :, :, :2].contiguous(),
                                    attn[:, :, :, :2].contiguous())
    assert msda_cuda.launches == before


K2_BACKWARD_CASES = {
    "small": dict(b=2, q=20, nh=8, hd=32, shapes=((20, 20), (10, 10), (5, 5))),
    "edge_hd8_q37_outside": dict(lo=-0.6, hi=1.6),
    "hd40_two_levels": dict(b=1, q=9, nh=3, hd=40, shapes=((5, 7), (3, 4)), p=3, lo=-1.0, hi=2.0),
    "rtdetr_l_train_b2": dict(b=2, q=556, nh=8, hd=32, shapes=RTDETR_L_SHAPES),  # 256 denoising + 300 queries
    "rtdetr_1280_large_v": dict(b=1, q=300, nh=8, hd=32, shapes=((160, 160), (80, 80), (40, 40))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_BACKWARD_CASES))
def test_k2_backward_matches_plain_autograd_on_card(card, case):
    """K2 under autograd on the card: one forward and one backward kernel
    launch, and value's, locs' and attn's gradients within 1e-5 of each
    one's largest magnitude of the plain version's autograd on the card and
    on the CPU (grad_value sums with atomics, in no fixed order); grad_locs
    and grad_attn bit for bit over two more launches of the backward kernel."""
    value, shapes, locs, attn = k2_inputs(4, **K2_BACKWARD_CASES[case])
    grad_out = torch.from_numpy(np.random.default_rng(5).normal(
        size=(value.shape[0], locs.shape[1], value.shape[2] * value.shape[3])).astype(np.float32))
    leaves = [t.cuda().requires_grad_(True) for t in (value, locs, attn)]
    before = (msda_cuda.launches, msda_cuda.backward_launches)
    msda_cuda.msda_sample_fused(leaves[0], shapes, leaves[1], leaves[2]).backward(grad_out.cuda())
    torch.cuda.synchronize()
    assert (msda_cuda.launches, msda_cuda.backward_launches) == (before[0] + 1, before[1] + 1)
    ref_gpu = msda_cuda.msda_sample_fused_backward_plain(value.cuda(), shapes, locs.cuda(), attn.cuda(),
                                                         grad_out.cuda())
    ref_cpu = msda_cuda.msda_sample_fused_backward_plain(value, shapes, locs, attn, grad_out)
    for name, got, rg, rc in zip(("value", "locs", "attn"), (t.grad for t in leaves), ref_gpu, ref_cpu):
        assert torch.isfinite(got).all(), name
        tol = 1e-5 * float(rc.abs().max())
        torch.testing.assert_close(got, rg, rtol=0, atol=tol, msg=name)
        torch.testing.assert_close(got.cpu(), rc, rtol=0, atol=tol, msg=name)
    again = [msda_cuda._launch_backward(value.cuda(), shapes, locs.cuda(), attn.cuda(), grad_out.cuda())
             for _ in range(2)]
    for i, name in ((1, "locs"), (2, "attn")):
        assert torch.equal(again[0][i], again[1][i]) and torch.equal(again[0][i], leaves[i].grad), name


@pytest.mark.cuda
def test_rtdetr_train_step_on_card_runs_k2_forward_and_backward(card, tmp_path):
    """One epoch of a narrow RT-DETR (tests/test_torch_rtdetr.py's NARROW, 2
    decoder layers) on the card: each micro-batch launches K2's forward and
    backward kernels once a decoder layer, and no plain path runs there."""
    data = shutil.copytree(FIXTURES / "torch_val_synth", tmp_path / "set")
    (data / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    m = RTDETR(dict(NARROW), device="cuda")
    before = (msda_cuda.launches, msda_cuda.backward_launches)
    m.train(data=str(data / "train.yaml"), epochs=1, imgsz=64, batch=4, nbs=4, workers=2, max_gt=4, num_dn=8,
            warmup_epochs=0.0, project=str(tmp_path / "runs"))
    torch.cuda.synchronize()
    micro = 16 // 4
    assert (msda_cuda.launches - before[0], msda_cuda.backward_launches - before[1]) == (2 * micro, 2 * micro)
    assert all(np.isfinite(v) for v in m.trainer.loss_history[0].values())


@pytest.mark.cuda
def test_rtdetr_l_predict_on_card_runs_k2_in_every_decoder_layer(card):
    """rtdetr-l at full width and depth on the card: 6 K2 launches per image
    (one per decoder layer), none of them from the plain version."""
    imgs = [np.random.default_rng(i).integers(0, 256, (480, 640, 3), dtype=np.uint8) for i in range(2)]
    m = RTDETR("rtdetr-l.yaml", device="cuda")
    before = msda_cuda.launches
    res = m.predict(imgs)
    assert msda_cuda.launches == before + 6 * len(imgs)
    assert all(0 <= len(r) <= 300 for r in res) and any(len(r) for r in res)
    assert all(np.isfinite(r.boxes.data).all() for r in res)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["yolov8n", "rtdetr-l"])
def test_card_predict_runs_in_full_f32_and_restores_tf32_flags(tf32_on, which):
    """With TF32 allowed by the caller, each predictor's device function runs
    with it off, and the flags are allowed again after the call."""
    m = YOLO("yolov8n.yaml", device="cuda") if which == "yolov8n" else RTDETR("rtdetr-l.yaml", device="cuda")
    seen = []
    m.model.register_forward_pre_hook(lambda *_: seen.append(_tf32()))
    m.predict([np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)], imgsz=64)
    assert seen == [(False, False)]
    assert _tf32() == (True, True)


@pytest.mark.cuda
def test_val_on_card_matches_val_on_cpu(tf32_on, tmp_path):
    """yolov8n with the reference-trained weights on the fixture set at 160 px:
    the card's mAP50 and mAP50-95 within 1e-3 of the CPU's (f32 forwards on
    two devices), K1 launched once per batch, TF32 off inside and restored."""
    ref = json.loads((FIXTURES / "val_parity_ref.json").read_text())
    fx = np.load(FIXTURES / "val_parity_model.npz")
    sd = {k[4:]: fx[k] for k in fx.files if k.startswith("sd::")}
    data = shutil.copytree(FIXTURES / "torch_val_synth", tmp_path / "set") / "data.yaml"
    kw = dict(imgsz=ref["val_args"]["imgsz"], batch=8, conf=ref["val_args"]["conf"],
              iou=ref["val_args"]["iou"], max_det=ref["val_args"]["max_det"])
    results = {}
    for device in ("cuda", "cpu"):
        y = yaml_model_load("yolov8n.yaml")
        y["nc"] = ref["dataset_args"]["nc"]
        model = YOLO(y, device=device)
        model.load_state_dict(sd)
        seen = []
        model.model.register_forward_pre_hook(lambda *_: seen.append(_tf32()))
        before = nms_cuda.launches
        results[device] = model.val(data=str(data), **kw)
        if device == "cuda":
            assert nms_cuda.launches == before + 2  # 16 images, batch 8
            assert seen == [(False, False)] * 2
    card, cpu = results["cuda"].box, results["cpu"].box
    assert abs(card.map50 - cpu.map50) <= 1e-3, (card.map50, cpu.map50)
    assert abs(card.map - cpu.map) <= 1e-3, (card.map, cpu.map)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(tf32_on, tmp_path):
    """One optimizer step of the reference-trained yolov8n through
    YOLO(...).train on the card and on the CPU (8 fixture images, 160 px,
    batch 8, nbs 8, no warmup): loss parts, parameters, momentum buffers,
    EMA and BN statistics within chip_smoke.TRAIN_PARITY_TOL (phase
    train_parity). TF32 stays off through every forward of the step and is
    allowed again afterwards."""
    from chip_smoke import TRAIN_PARITY_TOL, train_parity_diffs
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    seen = []  # the flags in every forward of a module in train mode: the steps' forwards
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, _: seen.append(_tf32()) if m.training else None)
    try:
        info = train_parity_diffs(YOLO, yaml_model_load, load_pickle, tmp_path)
    finally:
        handle.remove()
    assert seen and set(seen) == {(False, False)}
    assert _tf32() == (True, True)
    for k, v in info["max_rel_diff"].items():
        assert v <= TRAIN_PARITY_TOL["loss" if k.startswith("loss") else k], (k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["segment", "pose"])
def test_task_val_on_card_matches_cpu_and_k1_carries_the_payload(tf32_on, tmp_path, task):
    """The reference-trained yolov8n-seg / yolov8n-pose on its committed set at
    160 px: every mAP of the card within chip_smoke.TASK_FIXTURE_TOL of the
    CPU's, K1 once a batch; K1 on the first batch's captured rows bit for bit
    against its plain version, and the NMS outputs with the payload (32 mask
    coefficients, 15 keypoint values) equal to the plain path's."""
    from chip_smoke import TASK_FIXTURE_TOL, TASKS, capture_k1, gather_mismatch, metric, parity_yolov8n
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    spec = TASKS[task]
    ref = json.loads((FIXTURES / f"{spec['stem']}_ref.json").read_text())
    data = shutil.copytree(FIXTURES / spec["set"], tmp_path / "set") / "data.yaml"
    kw = dict(imgsz=ref["val_args"]["imgsz"], batch=8, conf=ref["val_args"]["conf"], iou=ref["val_args"]["iou"])
    maps = {}
    for device in ("cuda", "cpu"):
        model = parity_yolov8n(YOLO, yaml_model_load, ref, device, spec["stem"], spec["fixture_yaml"])
        before = nms_cuda.launches
        with capture_k1(ops_nms) as cap:
            m = model.val(data=str(data), **kw)
        maps[device] = [metric(m, a) for a, _ in spec["maps"]]
        if device == "cuda":
            assert nms_cuda.launches == before + 2  # 16 images, batch 8
            boxes, scores = cap["rows"]
            keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, kw["iou"], presorted=True)
            rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, kw["iou"])
            assert torch.equal(keep, rk) and torch.equal(valid, rv)
            assert cap["gather_out"]["extra"].shape[-1] == (32 if task == "segment" else 15)
            assert gather_mismatch(ops_nms, nms_cuda, cap) == 0
    assert np.abs(np.subtract(maps["cuda"], maps["cpu"])).max() <= TASK_FIXTURE_TOL, maps


def rotated_nms_rows(seed, b=2, a=5000, nc=15):
    """Seeded (B, A, 5) xywhr boxes in clusters, so that suppression happens,
    and (B, A, nc) scores: K = 4096 candidates a row at conf 0.25."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 1000, (b, a // 6, 2))
    pick = rng.integers(0, centres.shape[1], (b, a))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 8, (b, a, 2))
    wh = rng.uniform(8, 80, (b, a, 2))
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))
    rb = np.concatenate([xy, wh, ang], -1).astype(np.float32)
    return rb, rng.uniform(0, 1, (b, a, nc)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("agnostic", [False, True], ids=["per_class", "agnostic"])
def test_rotated_nms_on_card_keeps_what_the_cpu_keeps(card, agnostic):
    """non_max_suppression_rotated at K = 4096 on the card and on the CPU: the
    same candidates kept (their rboxes gathered bit for bit), valid flags,
    cls and scores equal."""
    from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression_rotated

    rb, scores = rotated_nms_rows(0)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, agnostic=agnostic)
    got = non_max_suppression_rotated(torch.from_numpy(rb).cuda(), torch.from_numpy(scores).cuda(), **kw)
    want = non_max_suppression_rotated(torch.from_numpy(rb), torch.from_numpy(scores), **kw)
    assert int(want["valid"].sum()) > 300
    for k in ("valid", "cls", "scores", "rboxes"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_classify_predict_and_val_on_card_match_cpu(tf32_on):
    """The fixture yolov8n-cls on the card and the CPU: predict's
    probabilities on 4 seeded images within 1e-5 and in full f32; val's top1
    and top5 on the fixture set at 64 px equal, and equal to the JAX
    validator's (val_parity_cls_ref.json)."""
    ref = json.loads((FIXTURES / "val_parity_cls_ref.json").read_text())
    imgs = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), dtype=np.uint8) for i in range(4)]
    probs, accs = {}, {}
    for device in ("cuda", "cpu"):
        model = cls_fixture_model(YOLO, yaml_model_load, device)
        seen = []
        model.model.register_forward_pre_hook(lambda *_: seen.append(_tf32()))
        probs[device] = np.stack([r.probs.data for r in model.predict(imgs, imgsz=64)])
        m = model.val(data=str(FIXTURES / "torch_cls_synth"), **ref["val_args"])
        accs[device] = (m.top1, m.top5)
        if device == "cuda":
            assert seen == [(False, False)] * 5
    np.testing.assert_allclose(probs["cuda"], probs["cpu"], atol=1e-5, rtol=0)
    assert accs["cuda"] == accs["cpu"] == (ref["results"]["top1"], ref["results"]["top5"])


@pytest.mark.cuda
def test_rtdetr_val_on_card_matches_cpu_and_runs_k2(tf32_on, tmp_path):
    """RTDETR("rtdetr-l.yaml").val on the fixture set at 64 px, batch 6 (the
    last batch padded by 2): 84 anchors, so every query is kept on both
    devices and only near-ties may reorder them. K2 launched 6 times a batch;
    each image's confidences (sorted) within 1e-4; mAP50 and mAP50-95 within
    1e-4; 16 images scored."""
    data = shutil.copytree(FIXTURES / "torch_val_synth", tmp_path / "set") / "data.yaml"
    runs = {}
    for device in ("cuda", "cpu"):
        before = msda_cuda.launches
        runs[device] = RTDETR("rtdetr-l.yaml", device=device).val(data=str(data), imgsz=64, batch=6)
        if device == "cuda":
            assert msda_cuda.launches == before + 6 * 3
    card, cpu = runs["cuda"], runs["cpu"]
    assert len(card.stats["conf"]) == len(cpu.stats["conf"]) == 16
    for g, w in zip(card.stats["conf"], cpu.stats["conf"]):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(np.sort(g), np.sort(w), atol=1e-4, rtol=0)
    assert abs(card.box.map50 - cpu.box.map50) <= 1e-4 and abs(card.box.map - cpu.box.map) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["yolo11n.yaml", "yolov10n.yaml"])
def test_zoo_forward_and_predict_on_card_match_cpu(card, cfg):
    """Predict on the card at 160 px, conf 1e-6: K1 launched once an image for
    yolo11n and never for yolov10n, 1-300 finite detections inside each
    image; then the same seeded weights on the card and the CPU as
    chip_smoke.zoo_parity holds them on the first letterboxed image (decoded
    outputs within ZOO_PARITY_TOL, yolov10n's one-to-one decode; the final
    rows made from the CPU's decode equal on both devices). The card's own
    rows are not compared with the CPU's: seeded scores sit within 1e-9 of
    each other, so their order is rounding."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    m = YOLO(cfg, device="cuda", seed=0)
    imgs = [np.random.default_rng(i).integers(0, 256, (120, 160, 3), dtype=np.uint8) for i in range(3)]
    before = nms_cuda.launches
    res = m.predict(imgs, imgsz=160, conf=1e-6)
    assert nms_cuda.launches == before + (0 if cfg == "yolov10n.yaml" else len(imgs))
    check_detections(res, imgs)
    info = zoo_parity(YOLO, ops_nms, full_f32, cfg[:-5], m, m.predictor.preprocess(imgs))
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
def test_k1_on_yolov3_tiny_rows_equals_plain(card):
    """yolov3-tiny predicts at 640 through K1 on rows of K = 40^2 + 20^2 =
    2,000 candidates (its two levels, P4 first); K1 on the captured rows
    equals its plain version bit for bit."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    m = YOLO("yolov3-tiny.yaml", device="cuda", seed=0)
    assert m.model.stride.tolist() == [16.0, 32.0]
    img = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    before = nms_cuda.launches
    with capture_k1(ops_nms) as cap:
        res = m.predict([img], conf=1e-6)
    assert nms_cuda.launches == before + 1 and 0 < len(res[0]) <= 300
    boxes, scores = cap["rows"]
    assert tuple(scores.shape) == (1, 2000) and cap["k1_kwargs"]["presorted"]
    keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, 0.7, presorted=True)
    rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, 0.7)
    assert torch.equal(keep, rk) and torch.equal(valid, rv)


ZOO2 = {  # the fixed-width YAMLs narrowed as the CPU tests narrow them
    "yolov5-anchor": {"depth_multiple": 0.33, "width_multiple": 0.25},
    "yolo12n": {},
    "gelan-c-dseg": {"depth_multiple": 0.33, "width_multiple": 0.25},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ZOO2))
def test_zoo2_forward_and_predict_on_card_match_cpu(card, name):
    """As test_zoo_forward_and_predict_on_card_match_cpu, for the anchor
    head (generic single-label NMS over its decoded rows), YOLO12's area
    attention and GELAN's DSegment (the mask coefficients as K1's payload,
    the coefficients and prototypes within ZOO_PARITY_TOL of their largest
    magnitude)."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    cfg = {**yaml_model_load(f"{name}.yaml"), **ZOO2[name]}
    m, cpu = YOLO(dict(cfg), device="cuda", seed=0), YOLO(dict(cfg), device="cpu", seed=0)
    imgs = [np.random.default_rng(i).integers(0, 256, (120, 160, 3), dtype=np.uint8) for i in range(3)]
    before = nms_cuda.launches
    res = m.predict(imgs, imgsz=160, conf=1e-6)
    assert nms_cuda.launches == before + len(imgs)
    check_detections(res, imgs)
    if name == "gelan-c-dseg":
        assert all(r.masks.data.shape[0] == len(r.boxes.data) for r in res)
    info = zoo_parity(YOLO, ops_nms, full_f32, name, m, m.predictor.preprocess(imgs), cpu=cpu)
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
def test_k1_on_anchor_head_rows_equals_plain(card):
    """A narrowed yolov5-anchor predicts at 640 through K1 on rows of K = 3 x
    (80^2 + 40^2 + 20^2) = 25,200 candidates (every anchor above conf 1e-6,
    under max_nms); K1 on the captured rows equals its plain version bit
    for bit."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    m = YOLO({**yaml_model_load("yolov5-anchor.yaml"), **ZOO2["yolov5-anchor"]}, device="cuda", seed=0)
    img = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    before = nms_cuda.launches
    with capture_k1(ops_nms) as cap:
        res = m.predict([img], conf=1e-6)
    assert nms_cuda.launches == before + 1 and 0 < len(res[0]) <= 300
    boxes, scores = cap["rows"]
    assert tuple(scores.shape) == (1, 25200) and cap["k1_kwargs"]["presorted"]
    keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, 0.7, presorted=True)
    rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, 0.7)
    assert torch.equal(keep, rk) and torch.equal(valid, rv)


@pytest.mark.cuda
@pytest.mark.parametrize("name,k", [("yolov7", 8400), ("yolov7-anchor", 25200)])
def test_k1_on_yolov7_rows_equals_plain(card, name, k):
    """A narrowed yolov7 (IDetect: the generic decode, K = 8400 at 640) and a
    narrowed yolov7-anchor (the implicit anchor head, K = 3 x (80^2 + 40^2 +
    20^2) = 25,200) predict at 640 through K1, once an image; K1 on the
    captured rows equals its plain version bit for bit; the same weights on
    the card and the CPU as chip_smoke.zoo_parity holds them."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    narrow = {"depth_multiple": 0.33, "width_multiple": 0.25}
    m = YOLO({**yaml_model_load(f"{name}.yaml"), **narrow}, device="cuda", seed=0)
    cpu = YOLO({**yaml_model_load(f"{name}.yaml"), **narrow}, device="cpu", seed=0)
    img = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    before = nms_cuda.launches
    with capture_k1(ops_nms) as cap:
        res = m.predict([img], conf=1e-6)
    assert nms_cuda.launches == before + 1 and 0 < len(res[0]) <= 300
    boxes, scores = cap["rows"]
    assert tuple(scores.shape) == (1, k)
    keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, 0.7, presorted=cap["k1_kwargs"].get("presorted", False))
    rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, 0.7)
    assert torch.equal(keep, rk) and torch.equal(valid, rv)
    info = zoo_parity(YOLO, ops_nms, full_f32, name, m, m.predictor.preprocess([img]), cpu)
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov8n-att", "hyper-yolo-n"])
def test_k1_on_att_and_hyper_rows_equals_plain(card, name):
    """yolov8n-att (BoT3, the deformable C2f_DCN and C2f_DLKA on the plain
    deformable conv) and hyper-yolo-n (MANet, the hypergraph conv) predict at
    640 through K1, once an image; K1 on the captured rows (K = 8400) equals
    its plain version bit for bit; the same weights on the card and the CPU
    as chip_smoke.zoo_parity holds them."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    m = YOLO(f"{name}.yaml", device="cuda", seed=0)
    cpu = YOLO(f"{name}.yaml", device="cpu", seed=0)
    img = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    before = nms_cuda.launches
    with capture_k1(ops_nms) as cap:
        res = m.predict([img], conf=1e-6)
    assert nms_cuda.launches == before + 1 and 0 < len(res[0]) <= 300
    boxes, scores = cap["rows"]
    assert tuple(scores.shape) == (1, 8400)
    keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, 0.7, presorted=cap["k1_kwargs"].get("presorted", False))
    rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, 0.7)
    assert torch.equal(keep, rk) and torch.equal(valid, rv)
    info = zoo_parity(YOLO, ops_nms, full_f32, name, m, m.predictor.preprocess([img]), cpu)
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolo11n-swin", "yolo11n-efficientformerv2", "yolo11n-ghostnetv2"])
def test_k1_on_whole_backbone_rows_equals_plain(card, name):
    """YOLO11 on Swin (shifted window attention), EfficientFormerV2 (its
    attention biases bound at 640) and GhostNetV2 (the DFC gates) predicts
    at 640 through K1, once an image; K1 on the captured rows (K = 8400)
    equals its plain version bit for bit; the same weights on the card and
    the CPU as chip_smoke.zoo_parity holds them."""
    test_k1_on_att_and_hyper_rows_equals_plain(card, name)


@pytest.mark.cuda
def test_v13_forward_and_predict_on_card_match_cpu(card):
    """yolov13n with its FullPAD gates seeded (chip_smoke.zoo_yolo) predicts
    on the card at 160 px through K1, once an image; the same weights on the
    card and the CPU as chip_smoke.zoo_parity holds them."""
    from ultralytics_pro_tpu_torch.nn.modules.v13 import FullPAD_Tunnel
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    m = zoo_yolo(YOLO, "yolov13n", "cuda")
    gates = [float(x.gate.detach()) for x in m.model.modules() if isinstance(x, FullPAD_Tunnel)]
    assert len(gates) == 7 and min(gates) >= 0.5
    imgs = [np.random.default_rng(i).integers(0, 256, (120, 160, 3), dtype=np.uint8) for i in range(3)]
    before = nms_cuda.launches
    res = m.predict(imgs, imgsz=160, conf=1e-6)
    assert nms_cuda.launches == before + len(imgs)
    check_detections(res, imgs)
    info = zoo_parity(YOLO, ops_nms, full_f32, "yolov13n", m, m.predictor.preprocess(imgs))
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov8s-DAttention", "yolov8s-ShuffleAttention"])
def test_attention_zoo_predict_on_card_matches_cpu(card, name):
    """An attention-zoo model at scale s (its zero-initialised parameters
    seeded, chip_smoke.zoo_yolo) predicts on the card at 640 px through K1,
    once an image, with 1-300 finite detections inside each image; the same
    weights on the card and the CPU as chip_smoke.zoo_parity holds them; K1
    on the captured rows equals its plain version bit for bit."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    m = zoo_yolo(YOLO, name, "cuda")
    imgs = [np.random.default_rng(i).integers(0, 256, (480, 640, 3), dtype=np.uint8) for i in range(2)]
    before = nms_cuda.launches
    with capture_k1(ops_nms) as cap:
        res = m.predict(imgs, conf=1e-6)
    assert nms_cuda.launches == before + len(imgs)
    check_detections(res, imgs)
    boxes, scores = cap["rows"]
    kw = cap["k1_kwargs"]
    keep, valid = nms_cuda.greedy_nms(boxes, scores, **kw)
    rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, kw["max_det"], kw["iou_thres"])
    assert torch.equal(keep, rk) and torch.equal(valid, rv)
    info = zoo_parity(YOLO, ops_nms, full_f32, name, m, m.predictor.preprocess(imgs))
    assert info["final_rows_mismatch"] == 0


@pytest.mark.cuda
def test_tta_predict_on_card_matches_cpu(card):
    """The trained fixture yolov8n's predict(augment=True) at 160 px: the same
    detections on the card and on the CPU (chip_smoke.tta_fixture), K1 once
    an image over the three passes' candidates."""
    before = nms_cuda.launches
    info = tta_fixture(YOLO, yaml_model_load)
    assert nms_cuda.launches == before + info["images"] and sum(info["detections"]) > 0


@pytest.mark.cuda
def test_rect_val_on_card_matches_cpu(tf32_on, tmp_path):
    """A rect val of the fixture set at 160 px (two batch shapes): every mAP
    on the card within 1e-4 of the CPU's, K1 once a batch, each batch's rows
    through K1 equal to its plain version."""
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    ref = json.loads((FIXTURES / "val_parity_ref.json").read_text())
    data = shutil.copytree(FIXTURES / "torch_val_synth", tmp_path / "set") / "data.yaml"
    kw = dict(data=str(data), imgsz=160, batch=8, conf=0.001, rect=True)
    before = nms_cuda.launches
    with capture_k1(ops_nms, every=True) as cap:
        got = parity_yolov8n(YOLO, yaml_model_load, ref, "cuda").val(**kw)
    assert nms_cuda.launches == before + 2
    want = parity_yolov8n(YOLO, yaml_model_load, ref, "cpu").val(**kw)
    for k, v in want.results_dict.items():
        assert abs(got.results_dict[k] - v) <= 1e-4, k
    shapes = set()
    for boxes, scores in cap["every_rows"]:
        shapes.add(tuple(scores.shape))
        keep, valid = nms_cuda.greedy_nms(boxes, scores, 300, 0.7, presorted=True)
        rk, rv = nms_cuda.greedy_nms_plain(boxes, scores, 300, 0.7)
        assert torch.equal(keep, rk) and torch.equal(valid, rv)
    assert len(shapes) == 2


@pytest.mark.cuda
def test_multi_scale_resize_on_card_matches_cpu(card, tmp_path):
    """An augmented batch of 8 fixture images at 160 px resized at every
    rung of the ladder (64 to 256 px: round(7.5) is 8) on the card and on
    the CPU: within 1 grey level (chip_smoke.multi_scale_rungs)."""
    host = aug_host_batch(fixture_train_set(tmp_path / "set", 8), 160, 8)
    rungs = multi_scale_rungs(host["img"], 160)
    assert sorted(rungs) == [64, 96, 128, 160, 192, 224, 256]
    assert all(r["max_grey_diff"] <= 1 for r in rungs.values())


@pytest.mark.cuda
def test_multi_scale_device_images_on_card_match_cpu(card, tmp_path):
    """The trainer's put_batch path under multi_scale (`device_images` with a
    size: the uint8 resize, the BGR flip, the one float conversion) on the
    card against the CPU: within 1 grey level at a rung down and one up."""
    from ultralytics_pro_tpu_torch.engine.trainer import device_images

    host = aug_host_batch(fixture_train_set(tmp_path / "set", 8), 160, 8)
    for size in (96, 224):
        got = device_images(host["img"], torch.device("cuda"), size).cpu()
        want = device_images(host["img"], torch.device("cpu"), size)
        assert got.shape == want.shape == (8, 3, size, size)
        assert ((got - want).abs().max() * 255).item() <= 1 + 1e-3


@pytest.mark.cuda
def test_augmented_step_on_card_matches_cpu(card, tmp_path):
    """One augmented optimizer step (Mosaic, the warp, HSV, flips) of the
    trained fixture yolov8n on 8 images at 160 px on the card and on the
    CPU, within chip_smoke's TRAIN_PARITY_TOL (one_step_diffs raises beyond)."""
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    data = fixture_train_set(tmp_path / "set", 8)
    info = one_step_diffs(*(train_one_step(YOLO, yaml_model_load, load_pickle, data, tmp_path / d, d, augment=True)
                            for d in ("cuda", "cpu")))
    assert info["ema_updates"] == [1, 1]


@pytest.mark.cuda
def test_predict_files_on_card_matches_per_image_predict(card, tmp_path):
    """The trained fixture yolov8n's predict_files of 48 fixture PNGs at
    batch 16 on the card against its per-image predict of the same files
    (chip_smoke.files_match_predict: counts and classes equal, boxes within
    1e-3 px): K1 once a batch, then once an image."""
    from chip_smoke import files_match_predict, files_set

    ref = json.loads((FIXTURES / "val_parity_ref.json").read_text())
    model = parity_yolov8n(YOLO, yaml_model_load, ref, "cuda")
    files = files_set(tmp_path / "files")[:48]
    nms_cuda.launches = 0
    info = files_match_predict(model, files, imgsz=160)
    assert info["detections"] > 0 and nms_cuda.launches == 3 + len(files)


@pytest.mark.cuda
def test_tracker_ids_on_card_equal_cpu(card, tmp_path):
    """The trained fixture yolov8n tracks an 8-frame panned sequence with
    BoT-SORT (GMC) and ByteTrack on the card and on the CPU: the same ids
    every frame, boxes within chip_smoke's TRACK_TOL (track_card_vs_cpu
    raises otherwise)."""
    from chip_smoke import pan_sequence, track_card_vs_cpu

    folder = pan_sequence(tmp_path / "pan", 8)
    for tracker in ("botsort.yaml", "bytetrack.yaml"):
        out = track_card_vs_cpu(YOLO, yaml_model_load, folder, tracker)
        assert sum(map(len, out["ids_per_frame"])) >= 8
