"""JPEG frames without cv2 or PIL: the counterpart of ``cv2.imread(path,
cv2.IMREAD_COLOR)`` on a JPEG, which the JAX package reads every frame with
(``data/pipelines/transforms.py``), equal to it bit for bit.

The decoder is the host C++ of ``csrc/jpeg_decode.cpp`` (libjpeg-turbo's
integer IDCT, fancy upsampling and colour tables, as cv2 builds them),
compiled with the host's ``g++`` by ``utils/host_build.py`` at first use and
loaded with ``ctypes.CDLL``, which releases the GIL for the call, so the
loader's threads decode in parallel. A failed build raises; there is no
fallback.

It reads Huffman-coded 8-bit baseline, extended sequential and progressive
JPEG with restart intervals, gray or YCbCr at 4:4:4, 4:2:2, 4:2:0 or 4:4:0,
and applies the Exif orientation as cv2 does. It raises ``UnsupportedImage``
on arithmetic coding, lossless and hierarchical files, 12-bit samples,
CMYK / YCCK and RGB-coded files, other sampling layouts, a progressive file
whose scans leave coefficients short of precision (libjpeg smooths those)
and on truncated or corrupt data, where libjpeg warns and fills in.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..utils import host_build

SOURCE = host_build.PKG / "csrc" / "jpeg_decode.cpp"
SIGNATURE = b"\xff\xd8\xff"
_MSG = 512
_U8P = ctypes.POINTER(ctypes.c_uint8)


class UnsupportedImage(ValueError):
    """A frame file the port cannot decode."""


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built decoder, loaded once per process."""
    lib = ctypes.CDLL(str(host_build.build(SOURCE)))
    lib.llvod_jpeg_header.restype = ctypes.c_int
    lib.llvod_jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_char_p, ctypes.c_int32]
    lib.llvod_jpeg_decode.restype = ctypes.c_int
    lib.llvod_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_char_p, ctypes.c_int32]
    return lib


def _check(status: int, msg, path: str) -> None:
    if status:
        kind = "unsupported JPEG" if status == 1 else "corrupt JPEG"
        raise UnsupportedImage(f"{path}: {kind}: {msg.value.decode()}")


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The JPEG in ``data`` as BGR uint8 [H, W, 3], turned as its Exif
    orientation says."""
    lib = load_library()
    msg = ctypes.create_string_buffer(_MSG)
    hw = (ctypes.c_int32 * 2)()
    _check(lib.llvod_jpeg_header(data, len(data), hw, msg, _MSG), msg, path)
    out = np.empty((hw[0], hw[1], 3), np.uint8)
    _check(lib.llvod_jpeg_decode(data, len(data), out.ctypes.data_as(_U8P),
                                 hw[0], hw[1], msg, _MSG), msg, path)
    return out
