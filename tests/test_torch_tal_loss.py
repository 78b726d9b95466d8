"""The port's IoU, assigner, detection loss and train-mode forward against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
(jitted, as tests/test_tal_loss.py runs it) and the port's, on the CPU.
Tolerances, each stated where it is checked:
- bbox_iou: values within 1e-6; CIoU's gradient within 1e-5 of `jax.grad`'s.
- TaskAlignedAssigner: fg_mask, target_gt_idx and target_labels exact,
  target_bboxes and target_scores within 1e-5; on `tal.npz` the limits of
  test_tal_parity (under 1% of anchors disagree with the reference).
- v8DetectionLoss: parts and total within 1e-5 relative; the gradient of the
  total with respect to the maps within 1e-4 of the largest JAX gradient;
  on `detect_loss.npz` the limits of test_detect_loss_parity.
- Train-mode forward of the carried yolov8n at 64 px, batch 2: maps within
  1e-4 of the largest, BN running statistics within 1e-5 relative or 1e-4
  of each tensor's largest (means near zero follow the maps' error), with
  the JAX package's two-pass variance (`BN_FAST_VARIANCE[0] = False`, set
  for the test and restored).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, load_fixture
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.nn.modules.conv import BatchNorm2d
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
from ultralytics_pro_tpu_torch.ops.anchors import bbox2dist
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou
from ultralytics_pro_tpu_torch.utils.loss import df_loss, v8DetectionLoss
from ultralytics_pro_tpu_torch.utils.tal import TaskAlignedAssigner
from ultralytics_pro_tpu_torch.utils.weights import load_torch_state_dict_file, torch_state_dict_to_jax

IOU_FORMS = {"iou": {}, "giou": {"GIoU": True}, "diou": {"DIoU": True}, "ciou": {"CIoU": True}}


@pytest.fixture
def two_pass_bn_variance():
    """The JAX BatchNorm's two-pass variance for the test, restored afterwards."""
    from ultralytics_pro_tpu.nn.modules import conv as jconv

    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    yield
    jconv.BN_FAST_VARIANCE[0] = saved


def _random_boxes(rng, n):
    """(n, 4) xywh boxes of varied sizes and overlaps."""
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


# -- bbox_iou ---------------------------------------------------------------

@pytest.mark.parametrize("form", list(IOU_FORMS))
def test_bbox_iou_matches_jax(form):
    from ultralytics_pro_tpu.ops.iou import bbox_iou as jiou

    fx = load_fixture("iou.npz")
    rng = np.random.default_rng(1)
    b1, b2 = _random_boxes(rng, 500), _random_boxes(rng, 500)
    kw = IOU_FORMS[form]
    for p1, p2 in ((fx["p1"], fx["p2"]), (b1, b2)):
        for xywh in (True, False):
            if not xywh:  # the same boxes as corners
                p1, p2 = (np.concatenate([p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2], -1) for p in (p1, p2))
            got = bbox_iou(torch.from_numpy(p1), torch.from_numpy(p2), xywh=xywh, **kw).numpy()
            want = np.asarray(jax.jit(lambda a, b: jiou(a, b, xywh=xywh, **kw))(p1, p2))
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got = bbox_iou(torch.from_numpy(fx["p1"]), torch.from_numpy(fx["p2"]), **kw).numpy()
    np.testing.assert_allclose(got, fx[form], atol=1e-5, rtol=1e-4)  # test_ops_iou's limits


def test_ciou_gradient_matches_jax_grad_with_alpha_held():
    from ultralytics_pro_tpu.ops.iou import bbox_iou as jiou

    rng = np.random.default_rng(2)
    b1, b2 = _random_boxes(rng, 400), _random_boxes(rng, 400)
    w = rng.normal(size=(400, 1)).astype(np.float32)
    gj = jax.grad(lambda a, b: (jiou(a, b, CIoU=True) * w).sum(), argnums=(0, 1))(b1, b2)
    t1, t2 = torch.tensor(b1, requires_grad=True), torch.tensor(b2, requires_grad=True)
    (bbox_iou(t1, t2, CIoU=True) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((t1.grad, t2.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_bbox2dist_and_df_loss_match_jax():
    from ultralytics_pro_tpu.ops.anchors import bbox2dist as jb2d
    from ultralytics_pro_tpu.utils.loss import df_loss as jdfl

    rng = np.random.default_rng(3)
    anchors = rng.uniform(0, 20, (300, 2)).astype(np.float32)
    boxes = np.concatenate([anchors - rng.uniform(-2, 25, (300, 2)),
                            anchors + rng.uniform(-2, 25, (300, 2))], -1).astype(np.float32)
    dist = bbox2dist(torch.from_numpy(anchors), torch.from_numpy(boxes), 16)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jb2d(anchors, boxes, 16)))
    assert float(dist.max()) == pytest.approx(15.99) and float(dist.min()) == 0.0
    logits = rng.normal(0, 2, (300, 4, 16)).astype(np.float32)
    got = df_loss(torch.from_numpy(logits), dist, 16).numpy()
    np.testing.assert_allclose(got, np.asarray(jdfl(logits, dist.numpy(), 16)), rtol=1e-6, atol=1e-6)


# -- TaskAlignedAssigner ----------------------------------------------------

def _assigner_inputs(seed, quantised):
    """b=3 images, G=7 slots (some padded, one image with none), A=336
    anchors of a 64 px, 3-level grid, nc=4. Quantised: scores on a grid of
    1/4 and boxes on whole grid cells, so align metrics tie heavily."""
    rng = np.random.default_rng(seed)
    b, g, nc = 3, 7, 4
    pts = [np.stack(np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5), -1).reshape(-1, 2) * s
           for n, s in ((16, 4), (8, 8), (4, 16))]
    anc = np.concatenate(pts).astype(np.float32)
    a = len(anc)
    scores = rng.uniform(0, 1, (b, a, nc))
    lt, wh = rng.uniform(-6, 0, (b, a, 2)), rng.uniform(4, 30, (b, a, 2))
    gxy, gwh = rng.uniform(0, 48, (b, g, 2)), rng.uniform(6, 40, (b, g, 2))
    if quantised:
        scores = np.ceil(scores * 4) / 4
        lt, wh = np.round(lt / 4) * 4, np.maximum(np.round(wh / 4) * 4, 4)
        gxy, gwh = np.round(gxy / 8) * 8, np.maximum(np.round(gwh / 8) * 8, 8)
    pd = np.concatenate([anc + lt, anc + lt + wh], -1)
    gt = np.concatenate([gxy, gxy + gwh], -1)
    labels = rng.integers(0, nc, (b, g))
    mask = rng.uniform(size=(b, g)) < 0.75
    mask[1] = False
    return [x.astype(np.float32) for x in (scores, pd, anc)] + [labels.astype(np.int32), gt.astype(np.float32), mask]


@pytest.mark.parametrize("quantised", [False, True], ids=["random", "ties"])
def test_assigner_matches_jax(quantised):
    from ultralytics_pro_tpu.utils.tal import TaskAlignedAssigner as JTAL

    args = _assigner_inputs(4, quantised)
    want = jax.jit(JTAL(topk=10, num_classes=4, alpha=0.5, beta=6.0).__call__)(*args)
    got = TaskAlignedAssigner(topk=10, num_classes=4, alpha=0.5, beta=6.0)(*map(torch.as_tensor, args))
    assert int(np.asarray(want.fg_mask).sum()) > 30  # the case assigns something
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("target_bboxes", "target_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_assigner_on_tal_fixture():
    fx = load_fixture("tal.npz")
    res = TaskAlignedAssigner(topk=10, num_classes=5, alpha=0.5, beta=6.0)(
        *(torch.from_numpy(fx[k]) for k in ("pd_scores", "pd_bboxes", "anc_points")),
        torch.from_numpy(fx["gt_labels"][..., 0]), torch.from_numpy(fx["gt_bboxes"]),
        torch.from_numpy(fx["mask_gt"][..., 0]))
    got_fg, ref_fg = res.fg_mask.numpy(), fx["fg_mask"].astype(bool)
    assert (got_fg != ref_fg).mean() < 0.01  # test_tal_parity's limits from here on
    fg = ref_fg & got_fg
    np.testing.assert_array_equal(res.target_gt_idx.numpy()[fg], fx["target_gt_idx"][fg])
    np.testing.assert_array_equal(res.target_labels.numpy()[fg], fx["target_labels"][fg])
    np.testing.assert_allclose(res.target_bboxes.numpy()[fg], fx["target_bboxes"][fg], atol=1e-4)
    np.testing.assert_allclose(res.target_scores.numpy()[fg], fx["target_scores"][fg], atol=1e-3, rtol=1e-3)


# -- v8DetectionLoss --------------------------------------------------------

def test_v8_loss_and_its_gradient_match_jax():
    """Random per-level maps (NCHW for the port, NHWC for JAX), a padded
    batch with an empty image and unused max_gt slots."""
    from ultralytics_pro_tpu.utils.loss import v8DetectionLoss as JLoss

    rng = np.random.default_rng(5)
    b, nc, g = 3, 5, 6
    feats = [rng.normal(0, 2, (b, 64 + nc, h, h)).astype(np.float32) for h in (8, 4, 2)]
    mask = rng.uniform(size=(b, g)) < 0.7
    mask[1] = False
    cls = (rng.integers(0, nc, (b, g)) * mask).astype(np.float32)
    xywh = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    batch = {"cls": cls, "bboxes": (xywh * mask[..., None]).astype(np.float32), "mask_gt": mask}

    def jloss(fs):
        return JLoss(nc, 16, (8, 16, 32))({"feats": [f.transpose(0, 2, 3, 1) for f in fs]},
                                          {k: jnp.asarray(v) for k, v in batch.items()}, (64, 64))

    (jt, jparts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(f) for f in feats])
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    tt, tparts = v8DetectionLoss(nc, 16, (8, 16, 32))(tf, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      (64, 64))
    tt.backward()
    assert float(jparts["box"]) > 0.1
    for k in ("box", "cls", "dfl"):
        assert float(tparts[k].detach()) == pytest.approx(float(jparts[k]), rel=1e-5)
    assert float(tt.detach()) == pytest.approx(float(jt), rel=1e-5)
    for got, want in zip(tf, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def _dense_batch(fx, g=8):
    """detect_loss.npz's flat (batch_idx, cls, bboxes) lists as a padded batch."""
    b = fx["input"].shape[0]
    cls, bboxes, mask = np.zeros((b, g), np.float32), np.zeros((b, g, 4), np.float32), np.zeros((b, g), bool)
    for i in range(b):
        sel = fx["batch_idx"] == i
        n = int(sel.sum())
        cls[i, :n], bboxes[i, :n], mask[i, :n] = fx["cls"][sel], fx["bboxes"][sel], True
    return {"cls": cls, "bboxes": bboxes, "mask_gt": mask}


def test_v8_loss_on_detect_loss_fixture():
    """The carried yolov8n in train mode on the reference's batch: the JAX
    test's limits (tests/test_tal_loss.py:60)."""
    fx = load_fixture("detect_loss.npz")
    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(load_torch_state_dict_file(f"{FIXTURES}/model_yolov8n.npz"))
    feats = model.train()(torch.from_numpy(fx["input"]))
    for i, f in enumerate(feats):
        ref = fx[f"feat{i}"]
        err = np.abs(f.detach().numpy() - ref) / (np.abs(ref) + 1e-2)
        assert np.median(err) < 5e-3 and np.quantile(err, 0.99) < 0.1
    batch = {k: torch.from_numpy(v) for k, v in _dense_batch(fx).items()}
    total, parts = v8DetectionLoss(nc=80, reg_max=16, strides=model.stride.tolist())(feats, batch, (64, 64))
    for k, ref in zip(("box", "cls", "dfl"), fx["items"]):
        np.testing.assert_allclose(float(parts[k].detach()), ref, rtol=0.05, atol=5e-3)
    np.testing.assert_allclose(float(total.detach()), fx["total"].sum(), rtol=0.05)


# -- train-mode forward and BatchNorm ---------------------------------------

def test_train_forward_and_bn_statistics_match_jax(two_pass_bn_variance):
    """Carried yolov8n, 64 px, batch 2: the deepest map is 2x2, so a BN there
    sees n = 8 values a channel and torch's unbiased running variance would
    be 8/7 of flax's."""
    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel

    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(load_torch_state_dict_file(f"{FIXTURES}/model_yolov8n.npz"))
    variables = torch_state_dict_to_jax(model.state_dict())
    x = np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jm = JModel("yolov8n.yaml")
    preds, upd = jax.jit(lambda v, xx: jm.module.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, x.transpose(0, 2, 3, 1))
    feats = model.train()(torch.from_numpy(x))
    assert [tuple(f.shape) for f in feats] == [(2, 144, 8, 8), (2, 144, 4, 4), (2, 144, 2, 2)]
    for got, want in zip(feats, preds["feats"]):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    got_stats = torch_state_dict_to_jax(model.state_dict())["batch_stats"]

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from leaves(v, (*path, k)) if isinstance(v, dict) else [((*path, k), np.asarray(v))]

    want_stats = dict(leaves(upd["batch_stats"]))
    got_stats = dict(leaves(got_stats))
    assert got_stats.keys() == want_stats.keys()
    deepest = ("layers_9", "cv2", "bn", "var")  # SPPF's output conv, on the 2x2 map
    assert deepest in got_stats
    for k, want in want_stats.items():
        np.testing.assert_allclose(got_stats[k], want, rtol=1e-5, atol=1e-4 * np.abs(want).max(),
                                   err_msg="/".join(k))


def test_batchnorm_updates_running_stats_with_the_biased_variance():
    torch.manual_seed(0)
    bn = BatchNorm2d(4, eps=1e-3, momentum=0.03)
    bn.running_mean.uniform_(-1, 1)
    bn.running_var.uniform_(0.5, 2)
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    x = torch.randn(2, 4, 2, 2) * 3 + 1
    y = bn.train()(x)
    var_b, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.97 * mean0 + 0.03 * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.97 * var0 + 0.03 * var_b, rtol=1e-6, atol=1e-7)
    assert not torch.allclose(bn.running_var, 0.97 * var0 + 0.03 * var_b * 8 / 7, rtol=1e-4)
    ref = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var_b.view(1, -1, 1, 1) + 1e-3)
    torch.testing.assert_close(y, ref * bn.weight.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1),
                               rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 0
    # eval mode normalises with the running statistics, as torch's layer does
    ev = bn.eval()(x)
    ref = torch.nn.functional.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, 1e-3)
    torch.testing.assert_close(ev, ref)
    assert math.isclose(bn.momentum, 0.03)
