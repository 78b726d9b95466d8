"""cv2.findContours (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) and cv2.contourArea, in numpy.

The JAX package's `engine/results.py:86` (`Masks.xy`) takes each mask's
largest outer contour by area. These copy what OpenCV 5.0.0 computes, held
to cv2 point for point by `tests/test_torch_sources.py`: Suzuki and Abe's
border following on the mask padded by one background pixel (so borders
touching the image are kept), in integers:

- the raster scan finds a 0 -> 1 step whose last border pixel met on the row
  (`lnbd`) is not a left border pixel of a component already followed (in
  external mode holes are not followed, and a step inside a followed
  component is skipped);
- from there the border is followed with cv2's 8-neighbour codes (0 east,
  counting counter-clockwise on screen), looking first from code 4 back
  through 3, 2, ... for the first foreground neighbour, then, at each pixel,
  turning from the code it came in by; a followed pixel is marked -2 where
  its east neighbour was looked at and found empty (a right border) and 2
  otherwise;
- CHAIN_APPROX_SIMPLE keeps a pixel where the code changes; a lone pixel
  is one point;
- the contours come out in the reverse of the order they were found, as
  cv2's tree gives them (its new contour becomes the first child).

`contour_area` is cv2's shoelace sum in f64, halved, its absolute value.
"""

from __future__ import annotations

import numpy as np

# cv2's chain codes: (dx, dy) of direction s, y pointing down
CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _follow(img: np.ndarray, x0: int, y0: int) -> list:
    """Follow the outer border starting at (x0, y0) of the padded int8 image,
    marking it; returns its CHAIN_APPROX_SIMPLE points (padded coordinates)."""
    s = end = 4
    while True:
        s = (s - 1) & 7
        dx, dy = CODE_DELTAS[s]
        if img[y0 + dy, x0 + dx] != 0 or s == end:
            break
    if s == end:  # no neighbour: a lone pixel
        img[y0, x0] = -2
        return [(x0, y0)]
    x1, y1 = x0 + CODE_DELTAS[s][0], y0 + CODE_DELTAS[s][1]  # the first neighbour found
    points = []
    x3, y3 = x0, y0
    prev_s = s ^ 4
    while True:
        end = s
        while True:
            s += 1
            dx, dy = CODE_DELTAS[s & 7]
            x4, y4 = x3 + dx, y3 + dy
            if img[y4, x4] != 0 or s >= 15:
                break
        s &= 7
        if (s - 1) & 0xFFFFFFFF < end:  # the east neighbour was looked at and is background
            img[y3, x3] = -2
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            points.append((x3, y3))
            prev_s = s
        if (x4, y4) == (x0, y0) and (x3, y3) == (x1, y1):
            break
        x3, y3 = x4, y4
        s = (s + 4) & 7
    return points


def find_contours(mask: np.ndarray) -> list:
    """cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0] of an
    (h, w) mask (nonzero is foreground): a list of (k, 1, 2) int32 contours."""
    ys, xs = np.nonzero(mask)
    if not len(ys):
        return []
    top, left = int(ys.min()), int(xs.min())  # scan the foreground's bounding box only
    crop = mask[top:int(ys.max()) + 1, left:int(xs.max()) + 1]
    h, w = crop.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = crop != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd_x = 0
        prev = 0
        x = 1
        while x < w + 1:
            steps = np.flatnonzero(row[x:w + 1] != prev)
            if not len(steps):
                break
            x += int(steps[0])
            p = int(row[x])
            if prev == 0 and p == 1 and img[y, lnbd_x] <= 0:
                found.append(_follow(img, x, y))
                p = int(row[x])
            prev = p
            if prev & -2:  # a followed pixel (2 or -2)
                lnbd_x = x
            x += 1
    shift = np.array([left - 1, top - 1], np.int32)
    return [np.array(pts, np.int32).reshape(-1, 1, 2) + shift for pts in reversed(found)]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea(contour) (not oriented)."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if not len(pts):
        return 0.0
    area = 0.0
    px, py = pts[-1]
    for x, y in pts.tolist():
        area += px * y - py * x
        px, py = x, y
    return abs(area * 0.5)
