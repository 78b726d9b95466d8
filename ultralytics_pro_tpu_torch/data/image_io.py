"""Image files to HWC uint8 BGR arrays, without OpenCV.

`imread(path)` is the counterpart of `cv2.imread(path)` (IMREAD_COLOR), which
`ultralytics_pro_tpu/data/dataset.py:318` calls:

- PNG with its own decoder (zlib and numpy): 8-bit gray, RGB or RGBA,
  non-interlaced, every row filter (None, Sub, Up, Average, Paeth). Gray is
  replicated to three channels and alpha is dropped, as cv2 does. None and
  Sub rows are reversed all at once and a run of Up rows as one running sum
  down the columns; Average and Paeth depend on the pixel to their left, so
  they loop over the row's bytes in Python.
- `.npy` with `np.load`.
- anything else, and PNG variants outside the list above, through PIL when
  PIL imports; otherwise it raises an error that names the file and the
  missing decoder.

`imsize(path)` gives an image's (h, w) without decoding it: a PNG's from its
IHDR chunk, any other file's through PIL (what the JAX dataset's rect
batching reads, `ultralytics_pro_tpu/data/dataset.py:74-81`).

`imwrite(path, img)` writes an (H, W, 3) uint8 BGR or (H, W) grey array as
an 8-bit PNG (row filter None, zlib level 1), which `imread` and cv2 read
back exactly.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel (gray, RGB, RGBA)


def imread(path) -> np.ndarray:
    """Read an image file as an (H, W, 3) uint8 BGR array (`.npy`: as stored)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Image not found {path}")
    if path.suffix.lower() == ".npy":
        return np.load(str(path))
    data = path.read_bytes()
    if data[:8] == PNG_SIGNATURE:
        decoded = _decode_png(data, path)
        if decoded is not None:
            return decoded
    return _read_with_pil(path)


def imsize(path) -> tuple:
    """(h, w) of an image file: a PNG's from its header, others through PIL."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def imwrite(path, img: np.ndarray) -> Path:
    """Write an (H, W, 3) uint8 BGR or (H, W) uint8 grey image as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"imwrite takes (H, W, 3) or (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = img if img.ndim == 2 else img[..., ::-1].reshape(h, w * 3)  # BGR -> RGB
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()  # filter byte 0 a row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(data)
    return path


def _read_with_pil(path: Path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise NotImplementedError(
            f"cannot decode {path}: ultralytics_pro_tpu_torch reads 8-bit non-interlaced gray/RGB/"
            "RGBA PNG and .npy itself; other formats need PIL, which is not installed") from None
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return np.ascontiguousarray(rgb[..., ::-1])


def _decode_png(data: bytes, path: Path):
    """The BGR array of a PNG the decoder takes, None for one it does not."""
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"truncated PNG chunk {kind!r} in {path}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n  # length, type, body, CRC
    if header is None or not idat:
        raise ValueError(f"{path} is not a complete PNG (no IHDR or IDAT)")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour not in _PNG_CHANNELS:
        return None
    bpp = _PNG_CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, want {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    img = _unfilter(rows, bpp, path)
    img = img.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def _unfilter(rows: np.ndarray, bpp: int, path: Path) -> np.ndarray:
    """Reverse the per-row filters: (H, 1 + stride) filtered -> (H, stride).
    None and Sub rows need no other row, so all of them are reversed at once;
    then, top to bottom, a run of Up rows is one running sum down the
    columns from the row above it, and Average and Paeth rows go byte by
    byte."""
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"{path}: unknown PNG row filter {kinds[y]} in row {y}")
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = rows[:, 1:].copy()
    sub = kinds == 1
    if sub.any():  # a running sum over the pixels to the left, per sample
        out[sub] = np.cumsum(out[sub].reshape(-1, stride // bpp, bpp), axis=1, dtype=np.uint8).reshape(-1, stride)
    zero = np.zeros(stride, np.uint8)
    starts = np.flatnonzero(np.r_[True, kinds[1:] != kinds[:-1]])
    for y, end in zip(starts, np.r_[starts[1:], h]):
        kind = int(kinds[y])
        if kind == 2:  # Up
            out[y:end] = np.cumsum(np.vstack([out[y - 1] if y else zero, out[y:end]]), axis=0, dtype=np.uint8)[1:]
        elif kind in (3, 4):
            for r in range(y, end):
                out[r] = np.frombuffer(_average_or_paeth(kind, bytearray(out[r].tobytes()),
                                                         (out[r - 1] if r else zero).tobytes(), bpp), np.uint8)
    return out


def _average_or_paeth(kind: int, cur: bytearray, prior: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4) reversed in place over one row's bytes."""
    if kind == 3:
        for i in range(bpp):
            cur[i] = (cur[i] + (prior[i] >> 1)) & 0xFF
        for i in range(bpp, len(cur)):
            cur[i] = (cur[i] + ((cur[i - bpp] + prior[i]) >> 1)) & 0xFF
        return cur
    for i in range(bpp):
        cur[i] = (cur[i] + prior[i]) & 0xFF  # a = c = 0: the predictor is b
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur
