"""Polygon fill and the uint8 bilinear shrink of OpenCV, in numpy, bit for bit.

The JAX collate (`ultralytics_pro_tpu/data/build.py:collate_detect:76-82`)
rasterises each segment polygon with `cv2.fillPoly` at the full image size
and shrinks it with `cv2.resize` (INTER_LINEAR). The port has no OpenCV, so
these are copies of what those two calls compute, for what the collate hands
them (an (h, w) uint8 image, one polygon of integer vertices, no shift):

- `fill_poly` follows OpenCV's drawing code: every edge, the horizontal ones
  too, is drawn as an 8-connected Bresenham line from its left end
  (`LineIterator`), an edge that leaves the image first clipped to it
  (`clipLine`); then the scanline fill (`FillEdgeCollection`) walks the
  non-horizontal edges in 16.16 fixed point, each over rows [y0, y1) from
  its upper vertex, and fills between the edges of each pair in x order,
  from ceil(left) to floor(right). An edge that leaves the image takes its
  slope from the clipped ends (a clip to one row leaves it vertical at the
  clipped x) and keeps its own rows.
- `resize_linear_u8` follows `cv2.resize`'s INTER_LINEAR on uint8: source
  positions (d + 0.5) * scale - 0.5 in f32, edge taps clamped, weights
  rounded to 11 bits, the horizontal pass in integers and the vertical one
  as cv2's vector code computes it (high halves of 16-bit products, then
  (sum + 2) >> 2); a shrink by exactly 2 on both axes is cv2's 2x2 average
  (`INTER_AREA`), as cv2 substitutes it.

`tests/test_torch_segment.py` holds both to cv2 (OpenCV 5.0.0) on the fixture
polygons and on seeded convex, star-shaped and self-crossing polygons, inside
the image, on its edge and crossing it.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
RESIZE_BITS = 11  # INTER_RESIZE_COEF_BITS


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine: the segment clipped to [0, w-1] x [0, h-1]. Returns
    (inside, x1, y1, x2, y2); the points are changed as OpenCV changes them,
    also where the segment misses the image."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8  # noqa: E731
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, *pts) -> bool:
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """An 8-connected line as cv::LineIterator(..., 8, leftToRight=true) walks it."""
    h, w = img.shape[:2]
    if _outside(w, h, (x1, y1), (x2, y2)):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # walk left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0


def fill_poly(img: np.ndarray, pts, value=1) -> np.ndarray:
    """`cv2.fillPoly(img, [pts], value)` for one polygon of integer vertices
    (k, 2) (x, y), on an (h, w) or (h, w, c) uint8 image; fills img in place
    and returns it."""
    h, w = img.shape[:2]
    v = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    edges = []  # (y0, x at y0 in 16.16, dx, y1)
    x0, y0 = v[-1]
    for x1, y1 in v:
        t0, t1 = (x0, y0), (x1, y1)
        _line8(img, x0, y0, x1, y1, value)
        c0 = [(x0 << XY_SHIFT), y0]
        c1 = [(x1 << XY_SHIFT), y1]
        if _outside(w, h, t0, t1):  # the edge runs from the clipped ends' x; their y only where they differ
            _, a, b, c, d = _clip_line(w, h, x0, y0, x1, y1)
            c0[0], c1[0] = a << XY_SHIFT, c << XY_SHIFT
            if b != d:
                c0[1], c1[1] = b, d
        if y0 != y1:
            dxe = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if y0 < y1:
                edges.append((y0, c0[0] + (y0 - c0[1]) * dxe, dxe, y1))
            else:
                edges.append((y1, c1[0] + (y1 - c1[1]) * dxe, dxe, y0))
        x0, y0 = x1, y1
    _fill_edges(img, edges, value)
    return img


def _fill_edges(img: np.ndarray, edges, value) -> None:
    """cv::FillEdgeCollection: rows from the lowest y0 to the last y1
    (exclusive) within the image; at each row the live edges' x in order,
    filled pair by pair from ceil(left) to floor(right)."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    ends = [x + (y1 - y0) * dx for y0, x, dx, y1 in edges]
    xs = [e[1] for e in edges] + ends
    y_min, y_max = min(e[0] for e in edges), max(e[3] for e in edges)
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    e = np.array(edges, np.int64)  # y0, x0, dx, y1
    for y in range(max(y_min, 0), min(y_max, h)):
        live = (e[:, 0] <= y) & (y < e[:, 3])
        xr = np.sort(e[live, 1] + (y - e[live, 0]) * e[live, 2])
        for xa, xb in zip(xr[0::2], xr[1::2]):
            a, b = (int(xa) + XY_ONE - 1) >> XY_SHIFT, int(xb) >> XY_SHIFT
            if a < w and b >= 0:
                img[y, max(a, 0):min(b, w - 1) + 1] = value


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv::resize's INTER_LINEAR taps along one axis: (first index, second
    index, first weight, second weight), weights in 11-bit fixed point.
    Horizontally an outside tap pulls its weight to the edge pixel
    (clamp_weights); vertically only the rows are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low] = 0
        s[high] = src - 1
    one = np.float32(1 << RESIZE_BITS)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size)` (INTER_LINEAR) of an (h, w) uint8 image to size (w, h)."""
    h0, w0 = img.shape
    w, h = size
    src = img.astype(np.int64)
    if (w0, h0) == (2 * w, 2 * h):  # cv2 runs INTER_AREA's 2x2 average instead
        return ((src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    xa, xb, a0, a1 = _linear_taps(w0, w, clamp_weights=True)
    ya, yb, b0, b1 = _linear_taps(h0, h, clamp_weights=False)
    rows = src[:, xa] * a0 + src[:, xb] * a1  # (h0, w), 11-bit fixed point
    # cv2's vector form of the vertical pass: rows >> 4 as int16, the high
    # halves of the 16x16-bit products, then (sum + 2) >> 2
    out = (((rows[ya] >> 4) * b0[:, None]) >> 16) + (((rows[yb] >> 4) * b1[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
