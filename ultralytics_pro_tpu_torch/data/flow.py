"""The OpenCV calls of BoT-SORT's camera-motion compensation, in numpy.

The JAX package's `trackers/bot_sort.py:29-66` (GMC) calls three cv2
functions, which the card's machine lacks. These are copies of what OpenCV
5.0.0 computes, held to cv2 itself by `tests/test_torch_track.py`:

- `good_features_to_track` (`goodFeaturesToTrack`, the min-eigenvalue
  detector, no mask): `corner_min_eig_val`'s map, bit for bit: the Sobel
  derivatives in f32 scaled by 1 / (4 * 3 * 255) (the x derivative's
  [s, 2s, s] column pass as one fused multiply-add over the [-1, 0, 1] row
  pass; the y derivative's [s, 2s, s] row pass as sequential fused
  multiply-adds over the first width // 32 * 32 columns, cv2's vector loop,
  and unfused in its scalar tail), their products, the unnormalised 3 x 3
  box sum (each row's three values summed in f64, the column's running f64
  sum updated row by row, cast to f32), then (a + c) - sqrt((a - c)^2 + b^2)
  with a, c halved; reflect-101 borders throughout. Then the threshold (kept
  where above quality_level times the largest value, in f32), the 3 x 3
  local maxima away from the outermost pixels, sorted by value and, among
  equal values, by address descending, and the minDistance grid.
- `calc_optical_flow_pyr_lk` (`calcOpticalFlowPyrLK`, no initial flow): the
  pyramids (`pyrDown`'s [1, 4, 6, 4, 1] integer taps, reflect-101, the level
  count cv2 stops at, every level padded by the window with reflect-101),
  the Scharr derivatives in integers (zero outside the level), the 14-bit
  bilinear weights rounded from f32, the window's values with 5 fractional
  bits and its derivatives in integers, the gradient matrix and the
  mismatch vector summed in f32 as cv2's 128-bit vector loop and scalar
  tail sum them, the update and the stop rules (epsilon squared in f64, the
  oscillation halving) in f32. Statuses are cv2's; the points are within
  3.3e-5 px of cv2's on the test frames (most bit for bit): the order in
  which cv2 sums the gradient matrix over its lanes is not copied exactly
  (ROADMAP.md section 3).
- `estimate_affine_partial_2d` (`estimateAffinePartial2D`, RANSAC): cv2's
  multiply-with-carry generator from its fixed seed drawing the 2-point
  subsets, the analytic 4-parameter model in f64, the reprojection errors
  in f32 against the squared threshold, the adaptive iteration count, so the
  inliers and the RANSAC model are cv2's bit for bit; cv2 then refines the
  model over its inliers with 10 Levenberg-Marquardt steps, and this copy
  takes their fixed point, the linear least-squares solution (the model is
  linear in its four parameters): within 1.1e-6 of cv2's matrix.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

F32, F64 = np.float32, np.float64
SOBEL_SCALE = F32(1.0 / (4 * 3 * 255))  # 1 / (2^(ksize - 1) * blockSize * 255) for ksize 3, blockSize 3
ROW_SIMD = 32  # Sobel's 8u->32f row filter: its vector loop's columns a step
LK_LANES = 4  # calcOpticalFlowPyrLK's f32 lanes in the gradient loop
LK_PAIRS = 8  # and its columns a step in the mismatch loop
W_BITS = 14
FLT_EPSILON = F32(np.finfo(np.float32).eps)
DBL_MIN = 2.2250738585072014e-308


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once (exact in f64 for these operands)."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def _pad101(img: np.ndarray, p: int) -> np.ndarray:
    return np.pad(img, p, mode="reflect")


# -- goodFeaturesToTrack -----------------------------------------------------
def _sobel_dx(img: np.ndarray) -> np.ndarray:
    x = _pad101(img.astype(np.int32), 1)
    r = (x[:, 2:] - x[:, :-2]).astype(F64)
    return _fma(r[:-2] + r[2:], SOBEL_SCALE, (r[1:-1] * F64(2 * SOBEL_SCALE)).astype(F32))


def _sobel_dy(img: np.ndarray) -> np.ndarray:
    x = _pad101(img.astype(np.int32), 1).astype(F64)
    a, b, c = x[:, :-2], x[:, 1:-1], x[:, 2:]
    n = a.shape[1] // ROW_SIMD * ROW_SIMD
    r = np.empty(a.shape, F32)
    r[:, :n] = _fma(c[:, :n], SOBEL_SCALE, _fma(b[:, :n], 2 * SOBEL_SCALE, (a[:, :n] * F64(SOBEL_SCALE)).astype(F32)))
    r[:, n:] = (a[:, n:].astype(F32) * SOBEL_SCALE + b[:, n:].astype(F32) * F32(2 * SOBEL_SCALE)) \
        + c[:, n:].astype(F32) * SOBEL_SCALE
    return r[2:] - r[:-2]


def _box3(v: np.ndarray) -> np.ndarray:
    """boxFilter(v, 3 x 3, normalize=False) of an f32 map, reflect-101."""
    x = _pad101(v.astype(F64), 1)
    rows = (x[:, :-2] + x[:, 1:-1]) + x[:, 2:]
    out = np.empty(v.shape, F32)
    run = rows[0] + rows[1]
    for y in range(v.shape[0]):
        total = run + rows[y + 2]
        out[y] = total
        run = total - rows[y]
    return out


def corner_min_eig_val(gray: np.ndarray, block_size: int = 3) -> np.ndarray:
    """cv2.cornerMinEigenVal(gray, 3, 3) of an (h, w) uint8 image: (h, w) f32."""
    if block_size != 3:
        raise NotImplementedError("corner_min_eig_val copies cv2's 3 x 3 block only")
    dx, dy = _sobel_dx(gray), _sobel_dy(gray)
    a = _box3(dx * dx) * F32(0.5)
    b = _box3(dx * dy)
    c = _box3(dy * dy) * F32(0.5)
    d = a - c
    return (a + c) - np.sqrt(b * b + d * d)


def good_features_to_track(gray: np.ndarray, max_corners: int = 1000, quality_level: float = 0.01,
                           min_distance: float = 1, block_size: int = 3):
    """cv2.goodFeaturesToTrack (min-eigenvalue, no mask): (n, 1, 2) f32
    corners (x, y), best first, or None where there is none."""
    eig = corner_min_eig_val(gray, block_size)
    eig = np.where(eig > F32(float(eig.max()) * quality_level), eig, F32(0))
    h, w = eig.shape
    p = np.pad(eig, 1, constant_values=-np.inf)
    dilated = p[:h, :w]
    for dy in range(3):
        for dx in range(3):
            dilated = np.maximum(dilated, p[dy:dy + h, dx:dx + w])
    inner = np.zeros((h, w), bool)
    inner[1:-1, 1:-1] = True
    ys, xs = np.nonzero((eig != 0) & (eig == dilated) & inner)
    order = np.lexsort((-xs, -ys, -eig[ys, xs]))  # value, then address, descending
    xs, ys = xs[order], ys[order]
    if min_distance >= 1 and round(min_distance) > 1:
        xs, ys = _spaced(xs, ys, w, h, min_distance, max_corners)
    if max_corners > 0:
        xs, ys = xs[:max_corners], ys[:max_corners]
    if not len(xs):
        return None
    return np.stack([xs, ys], -1).astype(F32)[:, None, :]


def _spaced(xs, ys, w: int, h: int, min_distance: float, max_corners: int):
    """goodFeaturesToTrack's minDistance grid over the sorted candidates
    (at minDistance 1 no two pixels are closer, so the caller skips it)."""
    cell = round(min_distance)
    gw, gh = (w + cell - 1) // cell, (h + cell - 1) // cell
    grid = {}
    d2 = min_distance * min_distance
    keep = []
    for i, (x, y) in enumerate(zip(xs.tolist(), ys.tolist())):
        cx, cy = x // cell, y // cell
        near = (grid.get((gx, gy), ()) for gy in range(max(cy - 1, 0), min(cy + 1, gh - 1) + 1)
                for gx in range(max(cx - 1, 0), min(cx + 1, gw - 1) + 1))
        if any(float(F32(x - px)) ** 2 + float(F32(y - py)) ** 2 < d2 for cellpts in near for px, py in cellpts):
            continue
        grid.setdefault((cx, cy), []).append((x, y))
        keep.append(i)
        if max_corners > 0 and len(keep) == max_corners:
            break
    return xs[keep], ys[keep]


# -- calcOpticalFlowPyrLK ----------------------------------------------------
def pyr_down(img: np.ndarray) -> np.ndarray:
    """cv2.pyrDown of an (h, w) uint8 image: ((h + 1) // 2, (w + 1) // 2)."""
    h, w = img.shape
    x = _pad101(img.astype(np.int32), 2)
    c = np.arange((w + 1) // 2) * 2 + 2
    r = x[:, c - 2] + 4 * x[:, c - 1] + 6 * x[:, c] + 4 * x[:, c + 1] + x[:, c + 2]
    c = np.arange((h + 1) // 2) * 2 + 2
    s = r[c - 2] + 4 * r[c - 1] + 6 * r[c] + 4 * r[c + 1] + r[c + 2]
    return ((s + 128) >> 8).astype(np.uint8)


def scharr_deriv(img: np.ndarray):
    """calcOpticalFlowPyrLK's Scharr derivatives (Ix, Iy) of a uint8 level, int32."""
    x = _pad101(img.astype(np.int32), 1)
    t0 = (x[:-2] + x[2:]) * 3 + x[1:-1] * 10
    t1 = x[2:] - x[:-2]
    return t0[:, 2:] - t0[:, :-2], (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10


def build_pyramid(img: np.ndarray, win: int, max_level: int) -> list:
    """The levels cv2.buildOpticalFlowPyramid keeps: it stops before a level
    whose width or height would not exceed the window."""
    levels = [img]
    h, w = img.shape
    for level in range(max_level + 1):
        if level:
            levels.append(pyr_down(levels[-1]))
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= win or h <= win:
            break
    return levels


def _bilinear_weights(ab: np.ndarray):
    """The 14-bit weights of the fractions ab (n, 2), rounded from f32."""
    a, b = ab[:, 0], ab[:, 1]
    one, s = F32(1), F32(1 << W_BITS)
    iw00 = np.rint((one - a) * (one - b) * s).astype(np.int32)
    iw01 = np.rint(a * (one - b) * s).astype(np.int32)
    iw10 = np.rint((one - a) * b * s).astype(np.int32)
    return iw00, iw01, iw10, (1 << W_BITS) - iw00 - iw01 - iw10


def _window(windows, r0, c0, iw, shift: int) -> np.ndarray:
    """The (n, win, win) bilinear window at padded rows r0, columns c0,
    descaled by shift bits as CV_DESCALE does."""
    p = windows[r0, c0]
    iw00, iw01, iw10, iw11 = (w[:, None, None] for w in iw)
    s = p[:, :-1, :-1] * iw00 + p[:, :-1, 1:] * iw01 + p[:, 1:, :-1] * iw10 + p[:, 1:, 1:] * iw11
    return (s + (1 << (shift - 1))) >> shift


def _sum_f32(terms: np.ndarray) -> np.ndarray:
    """Sequential f32 sums of terms (n, k, ...) over k, from 0."""
    zero = np.zeros((terms.shape[0], 1) + terms.shape[2:], F32)
    return np.add.accumulate(np.concatenate([zero, terms.astype(F32)], 1), axis=1, dtype=F32)[:, -1]


def _gradient_sum(p: np.ndarray) -> np.ndarray:
    """cv2's f32 sum of a window's products p (n, win, win): LK_LANES lanes
    over the vector columns, row by row, the scalar tail apart, then
    tail + ((l0 + l2) + (l1 + l3))."""
    n, win = p.shape[:2]
    nv = win // LK_LANES * LK_LANES
    q = _sum_f32(p[:, :, :nv].reshape(n, -1, LK_LANES))
    tail = _sum_f32(p[:, :, nv:].reshape(n, -1))
    return tail + ((q[:, 0] + q[:, 2]) + (q[:, 1] + q[:, 3]))


def _mismatch_sum(px: np.ndarray, py: np.ndarray):
    """cv2's f32 sums of diff * Ix and diff * Iy over a window: pairs of
    columns (x, x + 4) summed in int32 and converted, accumulated in two
    4-lane registers over blocks of LK_PAIRS columns, the scalar tail apart."""
    n, win = px.shape[:2]
    nb = win // LK_PAIRS * LK_PAIRS
    bx = px[:, :, :nb].reshape(n, win, -1, LK_PAIRS)
    by = py[:, :, :nb].reshape(n, win, -1, LK_PAIRS)
    qs = []
    for k in (0, 2):
        q = np.stack([bx[..., k] + bx[..., k + 4], by[..., k] + by[..., k + 4],
                      bx[..., k + 1] + bx[..., k + 5], by[..., k + 1] + by[..., k + 5]], -1)
        qs.append(_sum_f32(q.reshape(n, -1, 4)))
    q = qs[0] + qs[1]
    tail = _sum_f32(np.stack([px[:, :, nb:].reshape(n, -1), py[:, :, nb:].reshape(n, -1)], -1))
    return tail[:, 0] + (q[:, 0] + q[:, 2]), tail[:, 1] + (q[:, 1] + q[:, 3])


def calc_optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, prev_pts, win_size: int = 21, max_level: int = 3,
                             max_count: int = 30, epsilon: float = 0.01, min_eig_threshold: float = 1e-4):
    """cv2.calcOpticalFlowPyrLK(prev, nxt, prev_pts, None) of two (h, w) uint8
    images, a square window: (next_pts (n, 1, 2) f32, status (n, 1) uint8,
    err (n, 1) f32, the mean absolute window difference)."""
    pts = np.asarray(prev_pts, F32).reshape(-1, 2)
    n, win = len(pts), win_size
    prev_pyr, next_pyr = build_pyramid(prev, win, max_level), build_pyramid(nxt, win, max_level)
    max_level = len(prev_pyr) - 1
    status, err = np.ones(n, bool), np.zeros(n, F32)
    next_pts = np.zeros((n, 2), F32)
    half = F32((win - 1) * 0.5)
    scale = F32(1.0 / (1 << 20))
    eps2 = max(min(epsilon, 10.0), 0.0) ** 2
    inv_area = F32(2 * win * win)
    size = (win + 1, win + 1)

    def inside(p, h, w):
        return (p[:, 0] >= -win) & (p[:, 0] < w) & (p[:, 1] >= -win) & (p[:, 1] < h)

    for level in range(max_level, -1, -1):
        I, J = prev_pyr[level], next_pyr[level]
        h, w = I.shape
        ix, iy = scharr_deriv(I)
        win_i = sliding_window_view(_pad101(I.astype(np.int32), win), size)
        win_j = sliding_window_view(_pad101(J.astype(np.int32), win), size)
        win_ix, win_iy = sliding_window_view(np.pad(ix, win), size), sliding_window_view(np.pad(iy, win), size)
        prev_l = pts * F32(1.0 / (1 << level))
        next_pts = prev_l.copy() if level == max_level else next_pts * F32(2)
        prev_l = prev_l - half
        ip = np.floor(prev_l).astype(np.int64)
        ok = inside(ip, h, w)
        if level == 0:
            status &= ok
        idx = np.flatnonzero(ok)
        iw = _bilinear_weights(prev_l[idx] - ip[idx].astype(F32))
        r0, c0 = ip[idx, 1] + win, ip[idx, 0] + win
        Iw = _window(win_i, r0, c0, iw, W_BITS - 5)
        IXw, IYw = _window(win_ix, r0, c0, iw, W_BITS), _window(win_iy, r0, c0, iw, W_BITS)
        A11 = _gradient_sum(IXw * IXw) * scale
        A12 = _gradient_sum(IXw * IYw) * scale
        A22 = _gradient_sum(IYw * IYw) * scale
        D = A11 * A22 - A12 * A12
        d = A11 - A22
        min_eig = (A22 + A11 - np.sqrt(d * d + F32(4) * A12 * A12)) / inv_area
        good = ~((min_eig < F32(min_eig_threshold)) | (D < FLT_EPSILON))
        if level == 0:
            status[idx[~good]] = False
        row = np.full(n, -1)
        row[idx[good]] = np.arange(int(good.sum()))
        idx, Iw, IXw, IYw = idx[good], Iw[good], IXw[good], IYw[good]
        A11, A12, A22, D = A11[good], A12[good], A22[good], F32(1) / D[good]
        pt = next_pts[idx] - half
        prev_delta = np.zeros((len(idx), 2), F32)
        active = np.ones(len(idx), bool)
        for j in range(max_count):
            a = np.flatnonzero(active)
            inp = np.floor(pt[a]).astype(np.int64)
            inb = inside(inp, h, w)
            if level == 0:
                status[idx[a[~inb]]] = False
            active[a[~inb]] = False
            a, inp = a[inb], inp[inb]
            if not len(a):
                break
            iw = _bilinear_weights(pt[a] - inp.astype(F32))
            diff = _window(win_j, inp[:, 1] + win, inp[:, 0] + win, iw, W_BITS - 5) - Iw[a]
            b1, b2 = _mismatch_sum(diff * IXw[a], diff * IYw[a])
            b1, b2 = b1 * scale, b2 * scale
            delta = np.stack([(A12[a] * b2 - A22[a] * b1) * D[a], (A12[a] * b1 - A11[a] * b2) * D[a]], -1)
            pt[a] = pt[a] + delta
            next_pts[idx[a]] = pt[a] + half
            d64 = delta.astype(F64)
            done = d64[:, 0] * d64[:, 0] + d64[:, 1] * d64[:, 1] <= eps2
            if j > 0:
                s = np.abs(delta + prev_delta[a]).astype(F64)
                osc = ~done & (s[:, 0] < 0.01) & (s[:, 1] < 0.01)
                back = idx[a[osc]]
                next_pts[back] = next_pts[back] - delta[osc] * F32(0.5)
                done |= osc
            active[a[done]] = False
            prev_delta[a] = delta
        if level == 0:
            live = np.flatnonzero(status)
            q = next_pts[live] - half
            inp = np.floor(q).astype(np.int64)
            inb = inside(inp, h, w)
            status[live[~inb]] = False
            live, q, inp = live[inb], q[inb], inp[inb]
            iw = _bilinear_weights(q - inp.astype(F32))
            diff = _window(win_j, inp[:, 1] + win, inp[:, 0] + win, iw, W_BITS - 5) - Iw[row[live]]
            err[live] = _sum_f32(np.abs(diff).reshape(len(live), -1)) * F32(1.0 / (32 * win * win))
    return next_pts.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1), err.reshape(-1, 1)


# -- estimateAffinePartial2D -------------------------------------------------
class MWCRandom:
    """cv::RNG: multiply-with-carry on a 64-bit state, seeded with all ones."""

    def __init__(self, state: int = (1 << 64) - 1):
        self.state = state

    def next(self) -> int:
        self.state = ((self.state & 0xFFFFFFFF) * 4164903690 + (self.state >> 32)) & ((1 << 64) - 1)
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else self.next() % (b - a) + a


def _similarity(f: np.ndarray, t: np.ndarray) -> np.ndarray:
    """AffinePartial2DEstimatorCallback::runKernel: the 4-parameter model
    (rotation, uniform scale, translation) through two point pairs, f64."""
    x1, y1, x2, y2 = float(f[0, 0]), float(f[0, 1]), float(f[1, 0]), float(f[1, 1])
    X1, Y1, X2, Y2 = float(t[0, 0]), float(t[0, 1]), float(t[1, 0]), float(t[1, 1])
    den = (x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2)
    d = 1.0 / den if den else math.inf
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[s0, -s1, s2], [s1, s0, s3]])


def _reprojection_errors(m: np.ndarray, f: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Affine2DEstimatorCallback::computeError: squared distances in f32."""
    F = m.astype(F32).ravel()
    with np.errstate(invalid="ignore", over="ignore"):
        a = ((F[0] * f[:, 0] + F[1] * f[:, 1]) + F[2]) - t[:, 0]
        b = ((F[3] * f[:, 0] + F[4] * f[:, 1]) + F[5]) - t[:, 1]
        return a * a + b * b


def _ransac_iters(confidence: float, outlier_share: float, max_iters: int) -> int:
    """RANSACUpdateNumIters for 2-point models."""
    num = max(1.0 - confidence, DBL_MIN)
    denom = 1.0 - math.pow(1.0 - outlier_share, 2)
    if denom < DBL_MIN:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else round(num / denom)


def estimate_affine_partial_2d(from_pts, to_pts, ransac_reproj_threshold: float = 3.0, max_iters: int = 2000,
                               confidence: float = 0.99, refine_iters: int = 10):
    """cv2.estimateAffinePartial2D(from_pts, to_pts, method=RANSAC): ((2, 3)
    f64 matrix or None, inliers (n, 1) uint8)."""
    f = np.asarray(from_pts, F32).reshape(-1, 2)
    t = np.asarray(to_pts, F32).reshape(-1, 2)
    n = len(f)
    if n < 2:
        return None, np.zeros((n, 1), np.uint8)
    if n == 2:
        return _similarity(f, t), np.ones((n, 1), np.uint8)
    rng = MWCRandom()
    thresh = F32(ransac_reproj_threshold * ransac_reproj_threshold)
    best = best_mask = None
    max_good, niters, it = 0, max(max_iters, 1), 0
    while it < niters:
        i0 = rng.uniform(0, n)
        i1 = rng.uniform(0, n)
        while i1 == i0:
            i1 = rng.uniform(0, n)
        model = _similarity(f[[i0, i1]], t[[i0, i1]])
        mask = _reprojection_errors(model, f, t) <= thresh
        good = int(mask.sum())
        if good > max(max_good, 1):
            best, best_mask, max_good = model, mask, good
            niters = _ransac_iters(confidence, (n - good) / n, niters)
        it += 1
    if not max_good:
        return None, np.zeros((n, 1), np.uint8)
    if refine_iters:
        fi, ti = f[best_mask].astype(F64), t[best_mask].astype(F64)
        ones, zeros = np.ones(len(fi)), np.zeros(len(fi))
        A = np.empty((2 * len(fi), 4))
        A[0::2] = np.stack([fi[:, 0], -fi[:, 1], ones, zeros], 1)
        A[1::2] = np.stack([fi[:, 1], fi[:, 0], zeros, ones], 1)
        h = np.linalg.lstsq(A, ti.reshape(-1), rcond=None)[0]
        best = np.array([[h[0], -h[1], h[2]], [h[1], h[0], h[3]]])
    return best, best_mask.astype(np.uint8).reshape(-1, 1)
