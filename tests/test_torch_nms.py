"""K1 (greedy NMS) and the NMS entry points of the port against the JAX package.

The plain version of K1 must equal the JAX greedy loop and the Pallas kernel
(interpret mode) bit for bit; so must the wrapper's sort -> plain -> map-back
route that unsorted rows take on the card, and a numpy model of the CUDA kernel's tile
scan over sorted rows. The port's NMS entry points must equal the JAX
ones on the recorded NMS fixtures: keep decisions, classes and validity
exactly, boxes and scores to the bit as well (same f32 operations in the
same order), so every comparison below is exact.
"""

import numpy as np
import pytest
import torch

F32 = np.float32

from tests.conftest import load_fixture
from tests.test_torch_cuda import k1_inputs
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.kernels import nms_cuda
from ultralytics_pro_tpu_torch.ops import nms as tnms

CASES = {
    "default": dict(conf_thres=0.25, iou_thres=0.45),
    "val": dict(conf_thres=0.001, iou_thres=0.7, multi_label=True),
    "agnostic": dict(conf_thres=0.25, iou_thres=0.45, agnostic=True),
}


@pytest.mark.parametrize("seed,iou,max_det", [(0, 0.5, 64), (1, 0.7, 300)])
def test_plain_k1_equals_jax_greedy_and_pallas(seed, iou, max_det):
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.kernels.nms_pallas import pallas_greedy_nms
    from ultralytics_pro_tpu.ops.nms import _greedy_nms_scores

    boxes, scores = k1_inputs(seed)
    keep, valid = nms_cuda.greedy_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            max_det, iou)
    rk, rv = jax.vmap(lambda b, s: _greedy_nms_scores(b, s, iou, max_det))(
        jnp.asarray(boxes), jnp.asarray(scores))
    pk, pv = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), max_det=max_det,
                               iou_thres=iou, interpret=True)
    assert keep.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(pv))
    kept = valid.sum(1).tolist()
    assert kept[0] == 0 and 1 <= kept[1] <= 3 and 0 < min(kept[2:]) and max(kept) <= max_det
    assert kept[4] == max_det  # the zero-area box fills the row


def nms_rows(seed, b=9, k=96):
    """Seeded rows, unsorted, one hard case each: random; all -1; a row that
    runs out after 3 picks; scores on a coarse grid (ties); every live score
    equal; a zero-area box and an inverted box at high scores (neither
    suppresses itself); ties shared with a zero-area box; one class of boxes
    in tight clusters (most candidates suppressed, some scores exactly 0); a
    row whose only positive score belongs to a zero-area box."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(2, 40, (b, k, 2))
    cls = rng.integers(0, 3, (b, k, 1)) * 7680.0
    boxes = np.concatenate([xy, xy + wh], -1) + cls
    scores = np.where(rng.uniform(size=(b, k)) > 0.25, rng.uniform(size=(b, k)), -1.0)
    scores[1] = -1.0
    scores[2] = -1.0
    scores[2, rng.choice(k, 3, replace=False)] = rng.uniform(0.1, 1, 3)
    scores[3] = np.where(scores[3] > 0, np.ceil(scores[3] * 4) / 4, -1.0)
    scores[4] = np.where(scores[4] > 0, 0.5, -1.0)
    order = np.argsort(-scores[5], kind="stable")
    boxes[5, order[6], 2] = boxes[5, order[6], 0]  # zero width
    boxes[5, order[3], 1], boxes[5, order[3], 3] = boxes[5, order[3], 3], boxes[5, order[3], 1]  # y2 < y1
    scores[6] = np.where(scores[6] > 0, np.ceil(scores[6] * 3) / 3, -1.0)
    tied = np.flatnonzero(scores[6] == scores[6].max())
    boxes[6, tied[-1], 3] = boxes[6, tied[-1], 1]  # zero height, last of the top ties
    centres = rng.uniform(20, 80, (4, 2))[rng.integers(0, 4, k)] + rng.normal(0, 1.5, (k, 2))
    boxes[7] = np.concatenate([centres - 10, centres + 10], -1)
    scores[7] = np.where(rng.uniform(size=k) > 0.2, np.round(rng.uniform(size=k), 1), -1.0)
    scores[8] = -1.0
    scores[8, 5] = 0.9
    boxes[8, 5, 2] = boxes[8, 5, 0]
    return boxes.astype(np.float32), scores.astype(np.float32)


def _jax_greedy(boxes, scores, iou, max_det):
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops.nms import _greedy_nms_scores

    k, v = jax.vmap(lambda b, s: _greedy_nms_scores(b, s, iou, max_det))(
        jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("seed,iou,max_det", [(0, 0.45, 40), (1, 0.7, 96), (2, 0.5, 7),
                                              (3, 1.0, 12), (4, 0.0, 30)])
def test_sorted_rows_then_map_back_equal_the_argmax_form(seed, iou, max_det):
    """Greedy NMS on each row sorted stably by descending score, with keep
    mapped back to the row's own indices (the wrapper's route for rows that
    are not presorted), equals the JAX greedy loop and the port's plain
    version on the unsorted row, bit for bit. Exact: the same f32 operations
    pick the same boxes in the same order. iou 1.0 makes every box a box that
    does not suppress itself; iou 0.0 makes every overlap suppress."""
    boxes, scores = nms_rows(seed)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    keep, valid = nms_cuda._on_sorted_rows(nms_cuda.greedy_nms_plain, bt, st, max_det, iou)
    rk, rv = nms_cuda.greedy_nms_plain(bt, st, max_det, iou)
    jk, jv = _jax_greedy(boxes, scores, iou, max_det)
    assert keep.dtype == torch.int32 and valid.dtype == torch.bool
    for want_k, want_v in ((rk.numpy(), rv.numpy()), (jk, jv)):
        np.testing.assert_array_equal(keep.numpy(), want_k)
        np.testing.assert_array_equal(valid.numpy(), want_v)
    kept = valid.sum(1).tolist()
    assert kept[1] == 0 and kept[5] == kept[6] == kept[8] == max_det  # lazy boxes fill their rows
    assert 1 <= kept[2] <= 3 or iou >= 1


def _suppresses(bj, aj, bt, at, thres):
    """ops/nms.py:40-45 in f32, bj the winner; bt, at may be arrays."""
    w = np.maximum(np.minimum(bj[2], bt[..., 2]) - np.maximum(bj[0], bt[..., 0]), F32(0))
    h = np.maximum(np.minimum(bj[3], bt[..., 3]) - np.maximum(bj[1], bt[..., 1]), F32(0))
    inter = w * h
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / (aj + at - inter + F32(1e-7)) > F32(thres)


def tile_scan(boxes, scores, max_det, thres, tile):
    """A numpy model of csrc/greedy_nms.cu on one sorted row, with the tile
    size a parameter: (a) the tile's live candidates against the keeps so
    far, (b) each survivor's column mask of earlier survivors of the tile
    that suppress it, (c) survivors with an empty mask win, the rest are
    settled in rounds (a winner in the mask: lost; every one in the mask
    lost: won); winners are appended in order up to max_det or up to the
    first that does not suppress itself, which fills the rest. The row ends in the tile that holds its first
    score that is not > 0, or its last candidate."""
    k = len(scores)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = np.zeros(max_det, np.int32)
    valid = np.zeros(max_det, bool)
    kept, fill = [], -1
    for base in range(0, k, tile):
        idx = np.arange(base, min(base + tile, k))
        alive = scores[idx] > 0
        ends = len(idx) < tile or not alive.all()
        surv = []
        for a, i in zip(alive, idx):  # (a): i is the candidate, each keep the winner
            hit = any(_suppresses(boxes[j], area[j], boxes[i], area[i], thres) for j in kept)
            surv.append(bool(a) and not hit)
        col = [{m for m in range(n) if surv[m] and surv[n]
                and _suppresses(boxes[idx[m]], area[idx[m]], boxes[idx[n]], area[idx[n]], thres)}
               for n in range(len(idx))]  # (b)
        won = {n for n in range(len(idx)) if surv[n] and not col[n]}
        lost, undecided = set(), {n for n in range(len(idx)) if surv[n] and col[n]}
        while undecided:  # (c), in rounds: each settles at least the lowest undecided
            w = {n for n in undecided if col[n] <= lost}
            lo = {n for n in undecided if col[n] & won}
            won, lost, undecided = won | w, lost | lo, undecided - w - lo
        lazy = False
        for n in sorted(won):
            if len(kept) == max_det:
                break
            i = int(idx[n])
            if not _suppresses(boxes[i], area[i], boxes[i], area[i], thres):
                fill, lazy = i, True
                break
            kept.append(i)
        if ends or lazy or len(kept) == max_det:
            break
    keep[:len(kept)], valid[:len(kept)] = kept, True
    if fill >= 0:
        keep[len(kept):], valid[len(kept):] = fill, True
    return keep, valid


def _tile_scan_rows(tile):
    def fn(boxes, scores, max_det, thres):
        out = [tile_scan(b.numpy(), s.numpy(), max_det, thres, tile) for b, s in zip(boxes, scores)]
        return (torch.from_numpy(np.stack([o[0] for o in out])),
                torch.from_numpy(np.stack([o[1] for o in out])))
    return fn


@pytest.mark.parametrize("tile", [1, 7, 64])
@pytest.mark.parametrize("seed,iou,max_det", [(5, 0.45, 40), (6, 0.7, 96), (7, 1.0, 9), (8, 0.3, 20)])
def test_tile_scan_model_equals_plain_version(tile, seed, iou, max_det):
    """The kernel's tile scan, rehearsed in numpy with the tile size a
    parameter (1 is the plain in-order scan, 7 leaves ragged tiles, 64 is the
    kernel's), equals the plain argmax form bit for bit: on rows sorted as
    the main path hands them over, and on unsorted rows through the wrapper's
    sort and map back."""
    boxes, scores = nms_rows(seed)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    order = torch.sort(st, dim=1, descending=True, stable=True).indices
    sb, ss = torch.gather(bt, 1, order[..., None].expand(-1, -1, 4)), torch.gather(st, 1, order)
    got = _tile_scan_rows(tile)(sb, ss, max_det, iou)
    want = nms_cuda.greedy_nms_plain(sb, ss, max_det, iou)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    got = nms_cuda._on_sorted_rows(_tile_scan_rows(tile), bt, st, max_det, iou)
    want = nms_cuda.greedy_nms_plain(bt, st, max_det, iou)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_presorted_rows_go_straight_to_the_plain_version():
    """On the CPU the flag changes nothing: sorted rows give the plain
    version's result with or without it, and the sort route on the same rows
    agrees."""
    boxes, scores = nms_rows(9)
    order = np.argsort(-scores, axis=1, kind="stable")
    sb = torch.from_numpy(np.take_along_axis(boxes, order[..., None], 1))
    ss = torch.from_numpy(np.take_along_axis(scores, order, 1))
    fast = nms_cuda.greedy_nms(sb, ss, 50, 0.5, presorted=True)
    slow = nms_cuda.greedy_nms(sb, ss, 50, 0.5)
    plain = nms_cuda.greedy_nms_plain(sb, ss, 50, 0.5)
    routed = nms_cuda._on_sorted_rows(nms_cuda.greedy_nms_plain, sb, ss, 50, 0.5)
    for a, b, c, d in zip(fast, slow, plain, routed):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    boxes, scores = k1_inputs(2, b=4, k=64)
    before = nms_cuda.launches
    got = nms_cuda.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 20, 0.5)
    ref = nms_cuda.greedy_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 20, 0.5)
    assert nms_cuda.launches == before  # no kernel launch for CPU tensors
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_wrapper_refuses_other_devices():
    """A tensor off the CPU either launches the kernel or raises; a device that
    is neither CPU nor CUDA raises instead of falling back."""
    boxes = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nms_cuda.greedy_nms(boxes, torch.zeros(1, 8, device="meta"), 4, 0.5)


def _assert_outputs_equal(got, ref):
    for k in ("boxes", "scores", "cls", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_nms_equals_jax_on_fixture(case):
    from ultralytics_pro_tpu.ops.nms import non_max_suppression as jax_nms

    pred = load_fixture(f"nms_{case}.npz")["pred"]  # (B, 4+nc, A)
    boxes = np.ascontiguousarray(pred[:, :4].transpose(0, 2, 1))
    scores = np.ascontiguousarray(pred[:, 4:].transpose(0, 2, 1))
    kw = dict(max_det=300, **CASES[case])
    ref = jax_nms(boxes, scores, use_pallas=False, **kw)
    got = tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    assert int(got["valid"].sum()) > 0
    _assert_outputs_equal(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_nms_fused_equals_jax_on_fixture(case):
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops.nms import non_max_suppression_fused as jax_fused

    pred = load_fixture(f"nms_{case}.npz")["pred"]
    boxes = np.ascontiguousarray(pred[:, :4].transpose(0, 2, 1))
    scores = pred[:, 4:].transpose(0, 2, 1)
    conf = scores.max(-1)
    cls = scores.argmax(-1).astype(np.int32)
    kw = {k: v for k, v in CASES[case].items() if k != "multi_label"}
    ref = jax_fused(jnp.asarray(boxes), jnp.asarray(conf), jnp.asarray(cls), max_det=300,
                    use_pallas=False, **kw)
    got = tnms.non_max_suppression_fused(torch.from_numpy(boxes), torch.from_numpy(conf),
                                         torch.from_numpy(cls), max_det=300, **kw)
    assert int(got["valid"].sum()) > 0
    _assert_outputs_equal(got, ref)


def test_classes_filter_drops_disallowed_argmax_row():
    """The classes= case of tests/test_nms_fused.py, on both entry points."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops.nms import non_max_suppression as jax_nms
    from ultralytics_pro_tpu.ops.nms import non_max_suppression_fused as jax_fused

    boxes = np.asarray([[[32, 32, 10, 10], [100, 100, 10, 10], [0, 0, 0, 0]]], np.float32)
    scores = np.zeros((1, 3, 3), np.float32)
    scores[0, 0, 2], scores[0, 0, 0], scores[0, 1, 0] = 0.9, 0.8, 0.7
    allowed = (True, False, False)
    kw = dict(conf_thres=0.25, max_det=4, max_nms=3, classes=allowed)

    got = tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False, **kw)
    _assert_outputs_equal(got, ref)
    np.testing.assert_allclose(got["scores"][got["valid"]].tolist(), [0.7], atol=1e-6)

    conf, cls = scores.max(-1), scores.argmax(-1).astype(np.int32)
    gotf = tnms.non_max_suppression_fused(torch.from_numpy(boxes), torch.from_numpy(conf),
                                          torch.from_numpy(cls), **kw)
    reff = jax_fused(jnp.asarray(boxes), jnp.asarray(conf), jnp.asarray(cls), use_pallas=False, **kw)
    _assert_outputs_equal(gotf, reff)
    np.testing.assert_allclose(gotf["scores"][gotf["valid"]].tolist(), [0.7], atol=1e-6)


def test_multilabel_classes_filter_equals_jax():
    """classes= on the multi-label path zeroes the disallowed (anchor, class) pairs."""
    from ultralytics_pro_tpu.ops.nms import non_max_suppression as jax_nms

    rng = np.random.default_rng(2)
    boxes = rng.uniform(100, 500, (2, 64, 4)).astype(np.float32)
    scores = rng.uniform(0.3, 1, (2, 64, 4)).astype(np.float32)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=20, multi_label=True,
              classes=(True, False, True, False))
    got = tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jax_nms(boxes, scores, use_pallas=False, **kw)
    _assert_outputs_equal(got, ref)
    assert set(got["cls"][got["valid"]].tolist()) <= {0, 2}


def test_nms_indices_equals_jax():
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops.nms import nms_indices as jax_nms_indices

    boxes, scores = k1_inputs(3, b=1, k=128)
    scores = np.where(scores[0] > 0, scores[0], 0.0).astype(np.float32)
    keep, valid = tnms.nms_indices(torch.from_numpy(boxes[0]), torch.from_numpy(scores), 0.5, 40)
    rk, rv = jax_nms_indices(jnp.asarray(boxes[0]), jnp.asarray(scores), 0.5, 40)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))


def test_topk_ties_keep_index_order():
    """Candidate selection breaks score ties by index, as lax.top_k does."""
    import jax

    rng = np.random.default_rng(4)
    x = np.where(rng.uniform(0, 1, (3, 500)) > 0.5, np.round(rng.uniform(0, 1, (3, 500)), 1),
                 -1.0).astype(np.float32)
    vals, idx = tnms._topk(torch.from_numpy(x), 200)
    rv, ri = jax.lax.top_k(x, 200)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
