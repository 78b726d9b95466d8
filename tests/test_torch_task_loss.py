"""The port's segment, pose and OBB criteria and its rotated assigner against the JAX package.

The same seeded inputs (`tests/test_torch_cuda.py:task_loss_inputs`: 3
images at 64 px, nc 3, unused `max_gt` slots, an image with no object) go
through the JAX criterion (jitted, `jax.value_and_grad`) and the port's, on
the CPU. Tolerances, each stated where it is checked:
- RotatedTaskAlignedAssigner: fg_mask, target_gt_idx and target_labels
  exact; target_bboxes (all 5 columns, the angle among them) and
  target_scores within 1e-5.
- v8SegmentationLoss, v8PoseLoss (17x3 and 5x2), v8OBBLoss: each part and
  the total within 1e-5 relative; the gradient of the total with respect to
  each head output within 1e-4 of that tensor's largest JAX gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import (
    LOSS_NC,
    LOSS_RTOL,
    LOSS_STRIDES,
    assert_grads_close,
    port_criterion,
    port_loss_and_grads,
    task_loss_inputs,
)
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.ops.boxes import xywhr2xyxyxyxy
from ultralytics_pro_tpu_torch.utils.loss import v8PoseLoss
from ultralytics_pro_tpu_torch.utils.metrics import OKS_SIGMA
from ultralytics_pro_tpu_torch.utils.tal import RotatedTaskAlignedAssigner


def jax_criterion(task: str, kpt_shape=(17, 3), overlap_mask: bool = True, hyp=None):
    from ultralytics_pro_tpu.utils import loss

    kw = {"nc": LOSS_NC, "reg_max": 16, "strides": LOSS_STRIDES, "hyp": hyp}
    if task == "segment":
        return loss.v8SegmentationLoss(**kw, overlap_mask=overlap_mask)
    if task == "pose":
        return loss.v8PoseLoss(**kw, kpt_shape=kpt_shape)
    return loss.v8OBBLoss(**kw)


def jax_loss_and_grads(criterion, preds, batch):
    """The JAX criterion on the same inputs, NHWC maps and channel-last
    prototypes; the gradients in the port's layouts."""
    def to_jax(k, v):
        if k == "feats":
            return [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in v]
        return jnp.asarray(v.transpose(0, 2, 3, 1) if k == "protos" else v)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, parts), grads = jax.jit(jax.value_and_grad(lambda p: criterion(p, jb, (64, 64)), has_aux=True))(
        {k: to_jax(k, v) for k, v in preds.items()})
    back = {k: ([np.array(f).transpose(0, 3, 1, 2) for f in v] if k == "feats" else
                np.array(v).transpose(0, 3, 1, 2) if k == "protos" else np.array(v)) for k, v in grads.items()}
    return float(total), {k: float(v) for k, v in parts.items()}, back


def assert_same_loss(task, preds, batch, port_kw=None, jax_kw=None, min_box=0.1, nan_where=None):
    """The port's criterion against the JAX one; returns the port's parts and
    gradients. nan_where(key, jax_grad) -> the entries where the JAX gradient
    is known to be NaN: there the port's must be finite and 0."""
    got_total, got, got_grads = port_loss_and_grads(port_criterion(task, **(port_kw or {})), preds, batch)
    want_total, want, want_grads = jax_loss_and_grads(jax_criterion(task, **(jax_kw or port_kw or {})), preds, batch)
    for k, w in want_grads.items():
        for i, wi in enumerate(w if k == "feats" else [w]):
            expected = nan_where(k, wi) if nan_where else np.zeros(wi.shape, bool)
            np.testing.assert_array_equal(np.isnan(wi), expected, err_msg=k)
            gi = got_grads[k][i] if k == "feats" else got_grads[k]
            assert np.isfinite(gi).all() and not gi[expected].any(), k
            wi[expected] = 0.0
    assert got.keys() == want.keys()  # the JAX dict comes back with its keys sorted
    assert want["box"] > min_box
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL, abs=1e-12), (k, got, want)
    assert got_total == pytest.approx(want_total, rel=LOSS_RTOL)
    assert_grads_close(got_grads, want_grads)
    return got, got_grads


# -- RotatedTaskAlignedAssigner ---------------------------------------------

def _rotated_assigner_inputs(seed):
    """b=3 images, G=7 slots (some padded, one image with none), A=336
    anchors of a 64 px, 3-level grid, nc=4; predictions near the anchors."""
    rng = np.random.default_rng(seed)
    b, g, nc = 3, 7, 4
    pts = [np.stack(np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5), -1).reshape(-1, 2) * s
           for n, s in ((16, 4), (8, 8), (4, 16))]
    anc = np.concatenate(pts).astype(np.float32)
    a = len(anc)
    scores = rng.uniform(0, 1, (b, a, nc))
    pd = np.concatenate([anc + rng.normal(0, 2, (b, a, 2)), rng.uniform(4, 30, (b, a, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))], -1)
    gt = np.concatenate([rng.uniform(8, 56, (b, g, 2)), rng.uniform(6, 40, (b, g, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, g, 1))], -1)
    labels = rng.integers(0, nc, (b, g))
    mask = rng.uniform(size=(b, g)) < 0.75
    mask[1] = False
    return [x.astype(np.float32) for x in (scores, pd, anc)] + [labels.astype(np.int32), gt.astype(np.float32), mask]


def test_rotated_assigner_matches_jax_and_keeps_the_angle():
    from ultralytics_pro_tpu.utils.tal import RotatedTaskAlignedAssigner as JRTAL

    args = _rotated_assigner_inputs(7)
    want = jax.jit(JRTAL(topk=10, num_classes=4, alpha=0.5, beta=6.0).__call__)(*args)
    got = RotatedTaskAlignedAssigner(topk=10, num_classes=4, alpha=0.5, beta=6.0)(*map(torch.as_tensor, args))
    fg = got.fg_mask.numpy()
    assert fg.sum() > 30 and not fg[1].any()
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("target_bboxes", "target_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    # the targets are the assigned GTs' xywhr, the angle among them
    tb = got.target_bboxes.numpy()
    assert tb.shape == (3, 336, 5)
    gt = args[4]
    idx = got.target_gt_idx.numpy()
    np.testing.assert_array_equal(tb[fg], np.take_along_axis(gt, idx[..., None], 1)[fg])
    assert np.abs(tb[fg][:, 4]).max() > 0.1


def test_rotated_candidates_are_anchors_inside_the_turned_box():
    """The corner test against the JAX one, and against a direct check: the
    anchor turned into the box's frame lies within its half sides."""
    from ultralytics_pro_tpu.utils.tal import RotatedTaskAlignedAssigner as JRTAL

    _, _, anc, _, gt, _ = _rotated_assigner_inputs(8)
    got = RotatedTaskAlignedAssigner().select_candidates_in_gts(torch.from_numpy(anc), torch.from_numpy(gt)).numpy()
    want = np.asarray(JRTAL().select_candidates_in_gts(anc, gt))
    np.testing.assert_array_equal(got, want)
    d = anc[None, None] - gt[..., None, :2]
    cos, sin = np.cos(gt[..., 4])[..., None], np.sin(gt[..., 4])[..., None]
    u, v = d[..., 0] * cos + d[..., 1] * sin, -d[..., 0] * sin + d[..., 1] * cos
    inside = (np.abs(u) < gt[..., 2:3] / 2 - 1e-3) & (np.abs(v) < gt[..., 3:4] / 2 - 1e-3)
    outside = (np.abs(u) > gt[..., 2:3] / 2 + 1e-3) | (np.abs(v) > gt[..., 3:4] / 2 + 1e-3)
    assert got[inside].all() and not got[outside].any() and inside.sum() > 100
    assert xywhr2xyxyxyxy(torch.from_numpy(gt)).shape == (3, 7, 4, 2)


# -- the criteria -----------------------------------------------------------

@pytest.mark.parametrize("overlap_mask", [True, False])
def test_segment_loss_and_its_gradient_match_jax(overlap_mask):
    """Mask coefficients and prototypes get their gradients; overlap_mask is
    read by neither criterion, so False gives the loss of True in both."""
    preds, batch = task_loss_inputs("segment", seed=21)
    parts, grads = assert_same_loss("segment", preds, batch, port_kw={"overlap_mask": overlap_mask})
    assert list(parts) == ["box", "seg", "cls", "dfl"] and parts["seg"] > 0.1
    assert np.abs(grads["mc"]).max() > 0 and np.abs(grads["protos"]).max() > 0
    same, _ = assert_same_loss("segment", preds, batch, port_kw={"overlap_mask": not overlap_mask},
                               jax_kw={"overlap_mask": overlap_mask})
    assert same == parts


def test_segment_mask_loss_is_per_image_and_only_on_the_foreground():
    """The port forms logits for the foreground anchors only: the mask part
    equals the dense sum over every anchor (the JAX form, background weighted
    0) computed here with torch, and a batch without any object still gives
    every head output a (zero) gradient."""
    from ultralytics_pro_tpu_torch.ops.masks import crop_mask
    from ultralytics_pro_tpu_torch.utils.loss import bce_logits

    preds, batch = task_loss_inputs("segment", seed=22)
    crit = port_criterion("segment")
    t = {k: ([torch.from_numpy(f) for f in v] if k == "feats" else torch.from_numpy(v)) for k, v in preds.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    terms = crit.detect_terms(t["feats"], tb, (64, 64))
    got = crit.mask_loss(t["mc"], t["protos"], tb["masks"], terms.assign, (64, 64))
    assign = terms.assign
    tb_mask = assign.target_bboxes / 4
    area = ((tb_mask[..., 2] - tb_mask[..., 0]) * (tb_mask[..., 3] - tb_mask[..., 1])).clamp(min=1)
    dense = 0.0
    for i in range(3):
        pred = (t["mc"][i] @ t["protos"][i].reshape(32, -1)).reshape(-1, 16, 16)
        target = tb["masks"][i, assign.target_gt_idx[i]]
        per = crop_mask(bce_logits(pred, target), tb_mask[i]).sum((1, 2)) * assign.fg_mask[i]
        dense = dense + (per / area[i]).sum()
    assert float(got) == pytest.approx(float(dense / assign.fg_mask.sum()), rel=1e-6)

    preds, batch = task_loss_inputs("segment", seed=23, empty=True)
    parts, grads = assert_same_loss("segment", preds, batch, min_box=-1)
    assert parts["seg"] == parts["box"] == 0.0
    assert not np.abs(grads["mc"]).any() and not np.abs(grads["protos"]).any()


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["17x3", "5x2"])
def test_pose_loss_and_its_gradient_match_jax(kpt_shape):
    """17x3 takes OKS_SIGMA and the visibility BCE; 5x2 the 1/K sigmas and no
    kobj part; kobj's gain 2.0 (not its default) reaches the part."""
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 2.0}
    preds, batch = task_loss_inputs("pose", seed=31, kpt_shape=kpt_shape)
    parts, grads = assert_same_loss("pose", preds, batch, port_kw={"kpt_shape": kpt_shape, "hyp": hyp})
    assert list(parts) == ["box", "pose", "kobj", "cls", "dfl"] and parts["pose"] > 0.1
    assert (parts["kobj"] > 0.1) == (kpt_shape[1] == 3)
    assert np.abs(grads["kpt"]).max() > 0
    sigmas = v8PoseLoss(LOSS_NC, 16, LOSS_STRIDES, kpt_shape=kpt_shape).sigmas
    want = torch.from_numpy(OKS_SIGMA) if kpt_shape == (17, 3) else torch.full((5,), 0.2)
    torch.testing.assert_close(sigmas, want, rtol=0, atol=0)
    from ultralytics_pro_tpu.utils.loss import OKS_SIGMA as J_OKS_SIGMA

    np.testing.assert_array_equal(OKS_SIGMA, np.asarray(J_OKS_SIGMA))


def test_obb_loss_and_its_gradient_match_jax():
    """The 1.5 px GT drops out of the assignment; the probiou box loss gives
    the angle a gradient. Image 1 has no object: its anchors' targets are the
    empty slot's zero box, and the JAX criterion's gradient of its angles
    and box channels is NaN (probiou's sqrt at 0, times weight 0); the
    port's is 0 there (ROADMAP.md section 3)."""
    def nan_where(key, grad):
        where = np.zeros(grad.shape, bool)
        if key == "angle":
            where[1] = True
        else:
            where[1, :64] = True  # the box (DFL) channels of the empty image
        return where

    preds, batch = task_loss_inputs("obb", seed=41)
    parts, grads = assert_same_loss("obb", preds, batch, nan_where=nan_where)
    assert list(parts) == ["box", "cls", "dfl"]
    assert np.abs(grads["angle"]).max() > 1e-6

    crit = port_criterion("obb")
    calls, assign = [], crit.assigner
    crit.assigner = lambda *args: calls.append(args) or assign(*args)
    port_loss_and_grads(crit, preds, batch)
    args = calls[0]
    assert batch["mask_gt"][0, 0] and not bool(args[-1][0, 0])  # the 1.5 px GT is out of mask_gt
    assert bool(assign.select_candidates_in_gts(args[2], args[4])[0, 0].any())  # though an anchor lies in it
    res = assign(*args)
    assert res.fg_mask[0].any() and not (res.fg_mask[0] & (res.target_gt_idx[0] == 0)).any()


def test_task_trainers_build_their_criteria():
    """The trainers hand their criterion the gains, overlap_mask, and the Pose
    head's kpt_shape (5x3 here, so the 1/K sigmas)."""
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
    from ultralytics_pro_tpu_torch.models import task_map
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
    from ultralytics_pro_tpu_torch.utils import loss

    assert (DEFAULT_CFG_DICT["pose"], DEFAULT_CFG_DICT["kobj"], DEFAULT_CFG_DICT["overlap_mask"]) == (12.0, 1.0, True)
    want = {"segment": loss.v8SegmentationLoss, "pose": loss.v8PoseLoss, "obb": loss.v8OBBLoss}
    for task, cls in want.items():
        y = yaml_model_load({"segment": "yolov8n-seg.yaml", "pose": "yolov8n-pose.yaml",
                             "obb": "yolov8n-obb.yaml"}[task])
        y["nc"], y["kpt_shape"] = 2, [5, 3]
        model = YOLO(y, device="cpu").model
        args = {**DEFAULT_CFG_DICT, "batch": 2, "nbs": 8, "project": "unused", "kobj": 3.0, "overlap_mask": False}
        crit = task_map[task]["trainer"](model, args).criterion
        assert type(crit) is cls and crit.nc == 2 and crit.box_gain == 7.5
        if task == "segment":
            assert crit.overlap is False
        if task == "pose":
            assert crit.kpt_shape == (5, 3) and crit.kobj_gain == 3.0 and crit.pose_gain == 12.0
            torch.testing.assert_close(crit.sigmas, torch.full((5,), 0.2))
