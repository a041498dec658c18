"""Frame files without cv2 or PIL: the counterpart of ``cv2.imread(path,
cv2.IMREAD_COLOR)`` for PNG (the JAX package's
``data/pipelines/transforms.py::_imread``) and a PNG writer, with ``zlib``
and numpy only.

``imread`` decodes 8-bit, non-interlaced PNG (gray, gray with alpha, RGB,
RGBA, palette) into BGR uint8 [H, W, 3] as cv2 does: gray is repeated into
the three channels, alpha is dropped. It undoes the five PNG row filters.
Sub, Avg and Paeth depend on the byte to the left and Up, Avg and Paeth on
the row above, so an image with filtered rows is unfiltered along
anti-diagonals of pixels (the row above and the pixel to the left lie on
the previous diagonal), all rows of a diagonal at once; an image without
filtered rows is copied as it is.
Other PNG variants (16-bit, low bit depths, interlaced) and other formats
raise: JPEG frames wait for ROADMAP.md Queue 1's JPEG item.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (at 8 bits, a byte each)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
JPEG_ITEM = ("JPEG frames are not read yet (ROADMAP.md, Queue 1, the JPEG "
             "frames item); convert them to PNG")


class UnsupportedImage(ValueError):
    """A frame file the port cannot decode."""


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise UnsupportedImage(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise UnsupportedImage(f"{path}: truncated PNG")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(ftype: np.ndarray, rows: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """Any filters, along anti-diagonals of pixels: pixel (r, x) depends on
    (r, x-1), (r-1, x) and (r-1, x-1), all on diagonals before r + x.
    ``skew[d + 2, r + 1]`` holds pixel (r, d - r); the zero rows and
    columns around it are the PNG's zero neighbours beyond the image."""
    h = rows.shape[0]
    w = rows.shape[1] // bpp
    n_diag = h + w - 1
    r_idx, x_idx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    raw = np.zeros((n_diag, h, bpp), np.int16)
    raw[r_idx + x_idx, r_idx] = rows.reshape(h, w, bpp)
    skew = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    kind = ftype.astype(np.int64)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for d in range(n_diag):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = skew[d + 1, r0 + 1:r1 + 1]
        b = skew[d + 1, r0:r1]
        c = skew[d, r0:r1]
        pred = np.choose(kind[r0:r1], (zero[r0:r1], a, b, (a + b) >> 1,
                                       _paeth(a, b, c)))
        skew[d + 2, r0 + 1:r1 + 1] = (raw[d, r0:r1] + pred) & 255
    return skew[r_idx + x_idx + 2, r_idx + 1].astype(np.uint8).reshape(h, -1)


def read_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The PNG in ``data`` as uint8 [H, W, samples] in the file's order
    (gray; gray, alpha; R, G, B; R, G, B, A), a palette expanded to RGB."""
    if not data.startswith(PNG_SIGNATURE):
        raise UnsupportedImage(f"{path}: not a PNG")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise UnsupportedImage(f"{path}: no IHDR or no IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise UnsupportedImage(
            f"{path}: PNG of bit depth {depth}, colour type {color}, "
            f"interlace {interlace}; the port reads 8-bit non-interlaced PNG")
    bpp = CHANNELS[color]
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (w * bpp + 1):
        raise UnsupportedImage(f"{path}: {flat.size} bytes of pixel data "
                               f"for {h} x {w} x {bpp}")
    flat = flat.reshape(h, w * bpp + 1)
    ftype, rows = flat[:, 0], flat[:, 1:]
    if ftype.max(initial=0) > 4:
        raise UnsupportedImage(f"{path}: unknown row filter")
    if ftype.any():
        img = _unfilter_diagonals(ftype, rows, bpp)
    else:  # no row filter, the common case of written frames
        img = rows.copy()
    img = img.reshape(h, w, bpp)
    if color == 3:
        if palette is None:
            raise UnsupportedImage(f"{path}: palette PNG without PLTE")
        img = palette[img[..., 0]]
    return img


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` for PNG: BGR uint8 [H, W, 3].
    Raises FileNotFoundError for a missing file and UnsupportedImage for
    another format (naming the JPEG item for a JPEG)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if data.startswith(b"\xff\xd8\xff"):
        raise UnsupportedImage(f"{path}: {JPEG_ITEM}")
    img = read_png(data, path)
    if img.shape[-1] <= 2:  # gray (with alpha): repeat the gray
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def _filter_rows(img: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Filter each row of uint8 [H, W, bpp] with its type (0-4) from the
    original bytes; returns [H, 1 + W * bpp] with the type bytes."""
    if not ftype.any():
        return np.concatenate([np.zeros((img.shape[0], 1), np.uint8),
                               img.reshape(img.shape[0], -1)], axis=1)
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    kind = ftype.astype(np.int64)[:, None, None]
    pred = np.choose(kind, (np.zeros_like(x), a, b, (a + b) >> 1,
                            _paeth(a, b, c)))
    rows = ((x - pred) & 255).astype(np.uint8).reshape(img.shape[0], -1)
    return np.concatenate([ftype.astype(np.uint8)[:, None], rows], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def imwrite_png(path: str, img: np.ndarray,
                filters: Union[int, Sequence[int]] = 0, level: int = 6
                ) -> None:
    """Write uint8 ``img`` as an 8-bit PNG, as ``cv2.imwrite`` takes it:
    BGR [H, W, 3], BGRA [H, W, 4] or gray [H, W] / [H, W, 1]. ``filters``
    is the row filter type (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth), one for
    all rows or one per row; ``level`` is zlib's compression level."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(img.shape[-1])
    if img.ndim != 3 or color is None:
        raise ValueError(f"imwrite_png: shape {img.shape}")
    if color:  # BGR(A) -> RGB(A)
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    h, w = img.shape[:2]
    ftype = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if ftype.max(initial=0) > 4:
        raise ValueError(f"imwrite_png: filter types {set(ftype.tolist())}")
    body = zlib.compress(_filter_rows(img, ftype).tobytes(), level)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                + _chunk(b"IDAT", body) + _chunk(b"IEND", b""))
