"""OpenCV's `minAreaRect` in numpy, for the OBB labels.

The JAX dataset turns each label's four corners into (cx, cy, w, h, angle)
with `cv2.minAreaRect` (`ultralytics_pro_tpu/data/dataset.py:_poly2xywhr:276`).
The port has no OpenCV, so `min_area_rect` copies what OpenCV 5.0.0
computes for an (n, 2) float32 point set, in its own float32 arithmetic:

- `convexHull` (convhull.cpp, counter-clockwise, points returned): the
  points sorted by (x, y) (a stable sort, as std::sort's insertion sort is
  for so few points), Sklansky's scan over the upper and lower halves, and
  the cyclic shift that makes the hull's indices ascend or descend;
- `rotatingCalipers` (rotcalipers.cpp, CALIPERS_MINAREARECT): the edge
  vectors and their inverse lengths, the hull's orientation, four calipers
  started at the lowest, rightmost, highest and leftmost points, at each of
  n steps the caliper whose edge turns least (`firstVecIsRight`) moved on,
  and the rectangle of every step kept when its area is <= the least so far;
- `minAreaRect`'s centre from the kept rectangle's corner and sides, its
  sizes the sides' lengths, and its angle the first side's, turned by a
  multiple of 90 degrees into [-90, 0) (a quarter turn swaps the sizes; the
  angle is `atan2` of the turned side, in double, to degrees). A hull of two
  points is a segment of height 0, turned the same way.

Where the calipers tie (a square, an edge at 0 or 90 degrees) the choice of
edge decides the angle, and the sizes to the last bit decide the +pi/2 swap
of `poly2xywhr`, so a square's label depends on both.
`tests/test_torch_obb.py` holds both to cv2 on the fixture set's labels and
on seeded rectangles, clipped rectangles, squares and quadrilaterals.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(pts, start: int, end: int, stack: list, nsign: int, sign2: int) -> int:
    """convhull.cpp's Sklansky_ over pts[start..end] (sorted), float points,
    double products. Writes the chain's indices to stack; returns its length."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or (pts[start][0] == pts[end][0] and pts[start][1] == pts[end][1]):
        stack[0] = start
        return 1
    stack[0], stack[1], stack[2] = pprev, pcur, pnext
    stacksize = 3
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = F32(nexty - cury)
        if _sign(by) != nsign:
            ax = F32(pts[pcur][0] - pts[pprev][0])
            bx = F32(pts[pnext][0] - pts[pcur][0])
            ay = F32(cury - pts[pprev][1])
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[stacksize] = pnext
                stacksize += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[stacksize - 2] = pnext
                pcur = pprev
                pprev = stack[stacksize - 4]
                stacksize -= 1
        else:
            pnext += incr
            stack[stacksize - 1] = pnext
    return stacksize - 1


def convex_hull(points: np.ndarray) -> np.ndarray:
    """cv2.convexHull(points, clockwise=False, returnPoints=True) of (n, 2)
    float32 points -> (m, 2) float32 hull points in OpenCV's order."""
    data = np.asarray(points, F32).reshape(-1, 2)
    total = len(data)
    if total == 0:
        return data
    order = sorted(range(total), key=lambda i: (data[i][0], data[i][1]))  # stable
    pts = [data[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        y = pts[i][1]
        if pts[miny][1] > y:
            miny = i
        if pts[maxy][1] < y:
            maxy = i
    hull = []
    if pts[0][0] == pts[-1][0] and pts[0][1] == pts[-1][1]:
        hull.append(order[0])
    else:
        stack = [0] * (total + 2)
        tl_count = _sklansky(pts, 0, maxy, stack, -1, 1)
        tl = stack[:tl_count + 1]
        stack2 = [0] * (total + 2)
        tr_count = _sklansky(pts, total - 1, maxy, stack2, -1, -1)
        tr = stack2[:tr_count + 1]
        tl, tr, tl_count, tr_count = tr, tl, tr_count, tl_count  # counter-clockwise
        hull += [order[tl[i]] for i in range(tl_count - 1)]
        hull += [order[tr[i]] for i in range(tr_count - 1, 0, -1)]
        stop_idx = tr[1] if tr_count > 2 else tl[tl_count - 2] if tl_count > 2 else -1

        stack = [0] * (total + 2)
        bl_count = _sklansky(pts, 0, miny, stack, 1, -1)
        bl = stack[:bl_count + 1]
        stack2 = [0] * (total + 2)
        br_count = _sklansky(pts, total - 1, miny, stack2, 1, 1)
        br = stack2[:br_count + 1]
        if stop_idx >= 0:
            check_idx = bl[1] if bl_count > 2 else br[2 - bl_count] if bl_count + br_count > 2 else -1
            if check_idx == stop_idx or (check_idx >= 0 and pts[check_idx][0] == pts[stop_idx][0]
                                         and pts[check_idx][1] == pts[stop_idx][1]):
                # all points on one line: the lower chain mirrors the upper one
                bl_count, br_count = min(bl_count, 2), min(br_count, 2)
        hull += [order[bl[i]] for i in range(bl_count - 1)]
        hull += [order[br[i]] for i in range(br_count - 1, 0, -1)]
        hull = _ascending_shift(hull)
    return data[hull]


def _ascending_shift(hull: list) -> list:
    """The cyclic shift of the hull's indices that makes them ascend or
    descend, where one does (convhull.cpp's last step)."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                curr = hull[j]
                out.append(curr)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (curr < hull[nj]):
                    break
                j = nj
            else:
                return out
    return hull


def _first_vec_is_right(v1, v2) -> bool:
    """rotcalipers.cpp's firstVecIsRight: v1 turned 90 degrees clockwise, dotted with v2, < 0."""
    return F32(F32(v1[1] * v2[0]) + F32(-v1[0] * v2[1])) < 0


def _rotating_calipers(pts: np.ndarray):
    """rotcalipers.cpp's rotatingCalipers in CALIPERS_MINAREARECT mode over
    n > 2 hull points -> (corner, first side, second side), float32 pairs."""
    n = len(pts)
    vect = np.zeros((n, 2), F32)
    inv_len = np.zeros(n, F32)
    left = bottom = right = top = 0
    pt0 = pts[0]
    left_x = right_x = pt0[0]
    top_y = bottom_y = pt0[1]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = pts[i + 1 if i + 1 < n else 0]
        dx, dy = float(pt[0] - pt0[0]), float(pt[1] - pt0[1])
        vect[i] = (dx, dy)
        inv_len[i] = F32(1.0 / math.sqrt(dx * dx + dy * dy))
        pt0 = pt

    orientation = F32(0)
    ax, ay = float(vect[n - 1][0]), float(vect[n - 1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = F32(1) if convexity > 0 else F32(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("rotatingCalipers: the hull has no orientation")
    base_a, base_b = orientation, F32(0)

    seq = [bottom, right, top, left]
    minarea = F32(np.finfo(F32).max)
    best = None
    for _ in range(n):
        v0, v1, v2, v3 = vect[seq[0]], vect[seq[1]], vect[seq[2]], vect[seq[3]]
        rot = [v0, (v1[1], -v1[0]), (-v2[0], -v2[1]), (-v3[1], v3[0])]
        main = 0
        for i in range(1, 4):
            if _first_vec_is_right(rot[i], rot[main]):
                main = i
        p = seq[main]
        lead_x, lead_y = F32(vect[p][0] * inv_len[p]), F32(vect[p][1] * inv_len[p])
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n

        dx, dy = F32(pts[seq[1]][0] - pts[seq[3]][0]), F32(pts[seq[1]][1] - pts[seq[3]][1])
        width = F32(F32(dx * base_a) + F32(dy * base_b))
        dx, dy = F32(pts[seq[2]][0] - pts[seq[0]][0]), F32(pts[seq[2]][1] - pts[seq[0]][1])
        height = F32(F32(-dx * base_b) + F32(dy * base_a))
        area = F32(width * height)
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])

    left_i, a1, width, b1, height, bottom_i = best
    a2, b2 = -b1, a1
    c1 = F32(F32(a1 * pts[left_i][0]) + F32(pts[left_i][1] * b1))
    c2 = F32(F32(a2 * pts[bottom_i][0]) + F32(pts[bottom_i][1] * b2))
    idet = F32(F32(1) / F32(F32(a1 * b2) - F32(a2 * b1)))
    px = F32(F32(F32(c1 * b2) - F32(c2 * b1)) * idet)
    py = F32(F32(F32(a1 * c2) - F32(a2 * c1)) * idet)
    return (px, py), (F32(a1 * width), F32(b1 * width)), (F32(a2 * height), F32(b2 * height))


def _upright(x, y, w, h):
    """The side (x, y) of length w turned by a multiple of 90 degrees into
    [-90, 0) degrees; a quarter turn swaps w and h. Returns (w, h, angle)."""
    for x, y, first, second in ((x, y, w, h), (-y, x, h, w), (-x, -y, w, h), (y, -x, h, w)):
        angle = math.atan2(float(y), float(x)) * 180 / math.pi
        if -90 <= angle < 0:
            return first, second, F32(angle)
    raise ValueError(f"no quarter turn of ({x}, {y}) lies in [-90, 0) degrees")


def min_area_rect(points: np.ndarray):
    """cv2.minAreaRect of (n, 2) points (taken as float32) -> ((cx, cy),
    (w, h), angle in degrees, in [-90, 0)), as Python floats like cv2's."""
    hull = convex_hull(points)
    n = len(hull)
    cx = cy = w = h = angle = F32(0)
    if n > 2:
        (px, py), s1, s2 = _rotating_calipers(hull)
        cx = F32(px + F32(F32(s1[0] + s2[0]) * F32(0.5)))
        cy = F32(py + F32(F32(s1[1] + s2[1]) * F32(0.5)))
        w, h, angle = _upright(*s1, _norm(s1), _norm(s2))
    elif n == 2:
        cx = F32(F32(hull[0][0] + hull[1][0]) * F32(0.5))
        cy = F32(F32(hull[0][1] + hull[1][1]) * F32(0.5))
        d = (F32(hull[1][0] - hull[0][0]), F32(hull[1][1] - hull[0][1]))
        w, h, angle = _upright(*d, _norm(d), F32(0))
    elif n == 1:
        cx, cy = hull[0]
    return (float(cx), float(cy)), (float(w), float(h)), float(angle)


def _norm(v) -> F32:
    return F32(math.sqrt(float(v[0]) * float(v[0]) + float(v[1]) * float(v[1])))


def poly2xywhr(pts: np.ndarray) -> np.ndarray:
    """A label's 4 pixel corners -> (cx, cy, w, h, rad) float32 through
    `min_area_rect`, with w the long side: w < h swaps them and adds pi/2."""
    (cx, cy), (w, h), angle = min_area_rect(np.asarray(pts, F32))
    rad = np.deg2rad(angle)
    if w < h:
        w, h = h, w
        rad += np.pi / 2
    return np.array([cx, cy, w, h, rad], F32)
