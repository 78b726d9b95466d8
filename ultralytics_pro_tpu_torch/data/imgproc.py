"""The OpenCV calls of the train augmentations, in numpy, as OpenCV 5.0.0 computes them.

The JAX package's `data/augment.py` and `data/dataset.py` augment through
cv2, which the card's machine lacks. These are copies of what those calls
compute on uint8 images, each held to cv2 itself by
`tests/test_torch_augment.py`:

- `bgr2gray` (`COLOR_BGR2GRAY`): (3735 b + 19235 g + 9798 r + 2^14) >> 15.
- `bgr2hsv` (`COLOR_BGR2HSV`, hue in [0, 180)): cv2's integer form with its
  12-bit division tables. `hsv2bgr` (`COLOR_HSV2BGR`): in f32, s and v
  scaled by 1/255, the sector tables' entries v * (1 - s * f) as a fused
  multiply-add; cv2's vector loop takes 32 pixels of a row at a time and
  truncates, its scalar tail (the last width % 32) rounds to nearest, and
  the copy does the same by column.
- `bgr2ycrcb`, `ycrcb2bgr` (`COLOR_BGR2YCrCb`, `COLOR_YCrCb2BGR`): the
  14-bit fixed-point coefficients; `equalize_hist` (`equalizeHist`): the
  cumulative histogram times 255 / (n - the first bin's count) in f32,
  rounded; `gaussian_blur3` (`GaussianBlur(im, (3, 3), 0)`): [1, 2, 1] x
  [1, 2, 1] / 16 with reflect-101 edges, rounded half up.
- `rotation_matrix_2d` (`getRotationMatrix2D`).
- `warp_affine`, `warp_perspective` (`warpAffine`, `warpPerspective`;
  bilinear, a constant border): the inverse map in f32, a source
  coordinate per output pixel (affine: M0 * x + (M1 * y + M2) as a fused
  multiply-add in cv2's vector loop over 16 columns at a time, (M0 * x +
  M1 * y fused) + M2 in its scalar tail; perspective: the three rows
  fused the same way, then X / W), its floor and fraction, the four taps
  (a tap outside the image reads the border value) blended as fused
  multiply-adds in f32 and rounded. cv2 takes 2-channel images through its
  older fixed-point remap (`AB_BITS` 10, `INTER_BITS` 5, 15-bit weights,
  perspective rows computed in f64 in blocks of 16 x 64 pixels), and so
  do these copies; 1, 3 and 4 channels go the f32 way, any other count is
  refused (the JAX transforms warp more bands 4 at a time).

`resize_linear` is `cv2.resize(..., INTER_LINEAR)` of an HWC image, channel
by channel through `rasterize.resize_linear_u8`. The fused multiply-adds are
computed in f64 and rounded to f32 once; both are exact for these
operands but where a sum lands within 2^-53 of an f32 rounding midpoint.
"""

from __future__ import annotations

import math

import numpy as np

from ultralytics_pro_tpu_torch.data.rasterize import resize_linear_u8

F32, F64 = np.float32, np.float64
HSV_SHIFT = 12
YUV_SHIFT = 14
HSV_SIMD_PIXELS = 32  # cvtColor HSV2BGR's vector step: 4 vectors of 8 f32 lanes
WARP_SIMD_PIXELS = 16  # warpAffine / warpPerspective's vector step
INTER_BITS = 5
AB_BITS = 10
REMAP_BITS = 15


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once (computed in f64)."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def _descale(v, n: int):
    return (v + (1 << (n - 1))) >> n


# -- colour ------------------------------------------------------------------
def bgr2gray(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> (h, w) uint8."""
    x = img.astype(np.int64)
    return _descale(x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798, 15).astype(np.uint8)


def gray2bgr(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, axis=-1)


def _hsv_tables():
    i = np.arange(1, 256, dtype=F64)
    sdiv = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / i)]).astype(np.int32)
    hdiv = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * i))]).astype(np.int32)
    return sdiv, hdiv


_SDIV, _HDIV180 = _hsv_tables()


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> uint8 HSV, hue in [0, 180)."""
    x = img.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = _descale(diff * _SDIV[v], HSV_SHIFT)
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = _descale(h * _HDIV180[diff], HSV_SHIFT)
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 HSV (hue in [0, 180)) -> uint8 BGR."""
    h = hsv[..., 0].astype(F32) * F32(6.0 / 180)
    s = hsv[..., 1].astype(F32) * F32(1 / 255.0)
    v = hsv[..., 2].astype(F32) * F32(1 / 255.0)
    sector = np.floor(h)
    f = (h - sector).astype(F32)
    one = F32(1)
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one), v * _fma(-s, one - f, one)], -1).astype(F32)
    out = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1) * F32(255)
    width = hsv.shape[1]
    body = width - width % HSV_SIMD_PIXELS
    res = np.rint(out)
    res[:, :body] = np.floor(out[:, :body])
    return np.clip(res, 0, 255).astype(np.uint8)


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """cv2.LUT with a 256-entry table."""
    return table[img]


def bgr2ycrcb(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.int64)
    y = _descale(x[..., 0] * 1868 + x[..., 1] * 9617 + x[..., 2] * 4899, YUV_SHIFT)
    cr = _descale((x[..., 2] - y) * 11682 + (128 << YUV_SHIFT), YUV_SHIFT)
    cb = _descale((x[..., 0] - y) * 9241 + (128 << YUV_SHIFT), YUV_SHIFT)
    return np.clip(np.stack([y, cr, cb], -1), 0, 255).astype(np.uint8)


def ycrcb2bgr(ycc: np.ndarray) -> np.ndarray:
    x = ycc.astype(np.int64)
    y, cr, cb = x[..., 0], x[..., 1] - 128, x[..., 2] - 128
    b = y + _descale(cb * 29049, YUV_SHIFT)
    g = y + _descale(cb * -5636 + cr * -11698, YUV_SHIFT)
    r = y + _descale(cr * 22987, YUV_SHIFT)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def equalize_hist(gray: np.ndarray) -> np.ndarray:
    """cv2.equalizeHist of an (h, w) uint8 image."""
    hist = np.bincount(gray.ravel(), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    if hist[first] == gray.size:
        return np.full_like(gray, first)
    scale = F32(255.0) / F32(gray.size - hist[first])
    table = np.zeros(256, np.uint8)
    sums = (np.cumsum(hist) - hist[first]).astype(F32) * scale
    table[first + 1:] = np.clip(np.rint(sums[first + 1:]), 0, 255)
    return table[gray]


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of a uint8 image, HW or HWC."""
    x = np.pad(img.astype(np.int64), ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2), mode="reflect")
    rows = x[:, :-2] + 2 * x[:, 1:-1] + x[:, 2:]
    return ((rows[:-2] + 2 * rows[1:-1] + rows[2:] + 8) >> 4).astype(np.uint8)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size (w, h), interpolation=INTER_LINEAR), HW or HWC uint8."""
    if img.ndim == 2:
        return resize_linear_u8(img, size)
    return np.stack([resize_linear_u8(np.ascontiguousarray(img[..., c]), size) for c in range(img.shape[2])], -1)


# -- geometry ----------------------------------------------------------------
def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) f64, the centre taken as f32."""
    cx, cy = (float(F32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], F64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv::invertAffineTransform as warpAffine runs it, in f64."""
    m = np.asarray(m, F64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = m[1, 1] * d, m[0, 1] * -d, m[1, 0] * -d, m[0, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], F64)


def as_hwc(img: np.ndarray) -> np.ndarray:
    """An HW image as HW1; an HWC one as it is."""
    return img[..., None] if img.ndim == 2 else img


def _channels(img: np.ndarray) -> int:
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in (1, 2, 3, 4):
        raise ValueError(f"the warps take 1 to 4 channels, as cv2 does; got {c}")
    return c


def _taps(img: np.ndarray, ix: np.ndarray, iy: np.ndarray, border, dtype):
    """The four taps (y, x), (y, x+1), (y+1, x), (y+1, x+1) of every output
    pixel as `dtype`, a tap outside the image reading `border`: the uint8
    image framed by 2 px of border and the top-left tap clipped into the
    frame."""
    src = as_hwc(img)
    h, w, c = src.shape
    frame = np.empty((h + 4, w + 4, c), np.uint8)
    frame[:] = np.asarray(border, np.uint8)
    frame[2:h + 2, 2:w + 2] = src
    stride = w + 4
    flat = frame.reshape(-1, frame.shape[2])
    i00 = (np.clip(iy, -2, h) + 2) * stride + (np.clip(ix, -2, w) + 2)
    return tuple(flat[i].astype(dtype) for i in (i00, i00 + 1, i00 + stride, i00 + stride + 1))


def _bilinear_f32(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border) -> np.ndarray:
    """Bilinear samples at f32 source coordinates, taps outside reading `border`."""
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    ix = np.clip(fx, -3, img.shape[1] + 1).astype(np.int64)
    iy = np.clip(fy, -3, img.shape[0] + 1).astype(np.int64)
    p00, p01, p10, p11 = _taps(img, ix, iy, border, F32)
    top, bottom = _fma(a, p01 - p00, p00), _fma(a, p11 - p10, p10)
    out = np.clip(np.rint(_fma(b, bottom - top, top)), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def _bilinear_fixed(img: np.ndarray, x: np.ndarray, y: np.ndarray, border) -> np.ndarray:
    """cv2's remap of INTER_BITS fixed-point coordinates: 15-bit weights
    (32 - i)(32 - j) * 32, taps outside reading `border` (a pixel whose four
    taps all lie outside is `border` whatever the weights)."""
    sx, sy = x >> INTER_BITS, y >> INTER_BITS
    ax, ay = (x & 31)[..., None], (y & 31)[..., None]
    p00, p01, p10, p11 = _taps(img, sx, sy, border, np.int64)
    s = (p00 * (32 - ax) * (32 - ay) + p01 * ax * (32 - ay) + p10 * (32 - ax) * ay + p11 * ax * ay) * 32
    out = np.clip(_descale(s, REMAP_BITS), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def _border(border, c: int):
    b = (border,) * c if np.isscalar(border) else tuple(border)
    return (list(b) + [0] * 4)[:c]


def warp_affine(img: np.ndarray, m, dsize, border=114) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize (w, h), borderValue=border) with bilinear
    interpolation, for uint8 images of 1 to 4 channels."""
    c = _channels(img)
    w, h = dsize
    inv = _invert_affine(m)
    fill = _border(border, c)
    if c == 2:
        x, y = np.arange(w), np.arange(h)
        ad = np.rint(inv[0, 0] * x * (1 << AB_BITS)).astype(np.int64)
        bd = np.rint(inv[1, 0] * x * (1 << AB_BITS)).astype(np.int64)
        rd = (1 << AB_BITS) >> INTER_BITS >> 1
        x0 = np.rint((inv[0, 1] * y + inv[0, 2]) * (1 << AB_BITS)).astype(np.int64) + rd
        y0 = np.rint((inv[1, 1] * y + inv[1, 2]) * (1 << AB_BITS)).astype(np.int64) + rd
        shift = AB_BITS - INTER_BITS
        return _bilinear_fixed(img, (x0[:, None] + ad) >> shift, (y0[:, None] + bd) >> shift, fill)
    mf = inv.astype(F32).ravel()
    x = np.arange(w, dtype=F32)[None]
    y = np.arange(h, dtype=F32)[:, None]
    sx = _fma(mf[0], x, (mf[1] * y + mf[2]).astype(F32))
    sy = _fma(mf[3], x, (mf[4] * y + mf[5]).astype(F32))
    body = w - w % WARP_SIMD_PIXELS
    sx[:, body:] = (_fma(mf[0], x, (mf[1] * y).astype(F32)) + mf[2])[:, body:]
    sy[:, body:] = (_fma(mf[3], x, (mf[4] * y).astype(F32)) + mf[5])[:, body:]
    return _bilinear_f32(img, sx, sy, fill)


def _perspective_fixed(inv: np.ndarray, w: int, h: int):
    """WarpPerspectiveInvoker's coordinates: blocks of bh0 rows and bw0
    columns, each row of a block from its first column in f64."""
    bh0 = min(16, h)
    bw0 = min(1024 // bh0, w)
    m = inv.ravel()
    xs, ys = np.zeros((h, w), np.int64), np.zeros((h, w), np.int64)
    yy = np.arange(h, dtype=F64)[:, None]
    for x in range(0, w, bw0):
        x1 = np.arange(min(bw0, w - x), dtype=F64)[None]
        x0 = m[0] * x + m[1] * yy + m[2]
        y0 = m[3] * x + m[4] * yy + m[5]
        wgt = m[6] * x + m[7] * yy + m[8] + m[6] * x1
        with np.errstate(divide="ignore"):
            wgt = np.where(wgt != 0, (1 << INTER_BITS) / np.where(wgt != 0, wgt, 1), 0.0)
        lim = (-2.0 ** 31, 2.0 ** 31 - 1)
        xs[:, x:x + x1.shape[1]] = np.rint(np.clip((x0 + m[0] * x1) * wgt, *lim)).astype(np.int64)
        ys[:, x:x + x1.shape[1]] = np.rint(np.clip((y0 + m[3] * x1) * wgt, *lim)).astype(np.int64)
    return xs, ys


def warp_perspective(img: np.ndarray, m, dsize, border=114) -> np.ndarray:
    """cv2.warpPerspective(img, m, dsize (w, h), borderValue=border) with
    bilinear interpolation, for uint8 images of 1 to 4 channels."""
    c = _channels(img)
    w, h = dsize
    inv = np.linalg.inv(np.asarray(m, F64).reshape(3, 3))
    fill = _border(border, c)
    if c == 2:
        return _bilinear_fixed(img, *_perspective_fixed(inv, w, h), fill)
    mf = inv.astype(F32).ravel()
    x = np.arange(w, dtype=F32)[None]
    y = np.arange(h, dtype=F32)[:, None]
    body = w - w % WARP_SIMD_PIXELS
    rows = [_fma(mf[k], x, (mf[k + 1] * y + mf[k + 2]).astype(F32)) for k in (0, 3, 6)]
    for k, row in zip((0, 3, 6), rows):
        row[:, body:] = (_fma(mf[k], x, (mf[k + 1] * y).astype(F32)) + mf[k + 2])[:, body:]
    return _bilinear_f32(img, (rows[0] / rows[2]).astype(F32), (rows[1] / rows[2]).astype(F32), fill)
