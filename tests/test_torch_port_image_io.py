"""The port's PNG reader and writer (``data/image_io.py``) against cv2, which
the JAX package reads frames with (``cv2.imread(path, IMREAD_COLOR)``).
Decoding is byte-exact: on PNGs that cv2 writes (libpng's adaptive row
filters) at compression 0, 3 and 9; on PNGs written with each of the five
filter types forced on every row, and with a random type a row; on gray,
gray with alpha, RGB, RGBA and palette images; on odd widths. The writer
round-trips through both readers. A JPEG decodes as cv2 reads it
(``tests/test_torch_port_jpeg.py`` holds the decoder to cv2 in full); the
PNG variants the port does not read raise."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data import image_io as io


_pinned_threads = thread_count(1)


def _image(seed, shape):
    """Texture over a gradient, so that libpng's adaptive filtering picks
    several filter types."""
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0, 200, shape[0])[:, None]
    if len(shape) == 3:
        ramp = ramp[..., None]
    return (rng.randint(0, 56, shape) + ramp).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 31), (16, 17, 4),
                                   (64, 65, 3), (1, 7, 3), (9, 1)])
def test_decode_cv2_written_png_byte_exact(tmp_path, shape, level):
    img = _image(level, shape)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = io.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("shape", [(23, 41, 3), (19, 33), (11, 29, 4)])
def test_decode_forced_filters_byte_exact(tmp_path, shape, filters):
    img = _image(7, shape)
    if filters == "mixed":
        filters = np.random.RandomState(1).randint(0, 5, shape[0])
    path = str(tmp_path / "b.png")
    io.imwrite_png(path, img, filters=filters)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(io.imread(path), want)
    # the writer round-trips: the decoded samples are the image's
    expect = img if img.ndim == 2 else img[..., :3]
    np.testing.assert_array_equal(
        cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., :3] if img.ndim == 3
        else cv2.imread(path, cv2.IMREAD_UNCHANGED), expect)


def _png(rows, w, h, color, palette=None, depth=8, interlace=0):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    out = io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def test_decode_gray_alpha_and_palette(tmp_path):
    rng = np.random.RandomState(3)
    ga = rng.randint(0, 256, (13, 15, 2)).astype(np.uint8)
    path = tmp_path / "ga.png"
    path.write_bytes(_png(ga, 15, 13, 4))
    np.testing.assert_array_equal(io.imread(str(path)),
                                  cv2.imread(str(path), cv2.IMREAD_COLOR))
    pal = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = rng.randint(0, 16, (13, 15)).astype(np.uint8)
    path = tmp_path / "p.png"
    path.write_bytes(_png(idx, 15, 13, 3, palette=pal))
    np.testing.assert_array_equal(io.imread(str(path)),
                                  cv2.imread(str(path), cv2.IMREAD_COLOR))


def test_writer_round_trips(tmp_path):
    img = np.random.RandomState(4).randint(0, 256, (31, 47, 3)
                                           ).astype(np.uint8)
    for f in range(5):
        path = str(tmp_path / f"r{f}.png")
        io.imwrite_png(path, img, filters=f, level=9)
        np.testing.assert_array_equal(io.imread(path), img)
        np.testing.assert_array_equal(cv2.imread(path), img)


def test_jpeg_and_unsupported_pngs_raise(tmp_path):
    img = _image(5, (16, 16, 3))
    jpg = str(tmp_path / "a.jpg")
    assert cv2.imwrite(jpg, img)
    np.testing.assert_array_equal(io.imread(jpg),
                                  cv2.imread(jpg, cv2.IMREAD_COLOR))
    deep = tmp_path / "d.png"
    deep.write_bytes(_png(np.zeros((4, 24), np.uint8), 4, 4, 2, depth=16))
    with pytest.raises(io.UnsupportedImage, match="bit depth 16"):
        io.imread(str(deep))
    inter = tmp_path / "i.png"
    inter.write_bytes(_png(np.zeros((4, 12), np.uint8), 4, 4, 2,
                           interlace=1))
    with pytest.raises(io.UnsupportedImage, match="interlace 1"):
        io.imread(str(inter))
    with pytest.raises(FileNotFoundError):
        io.imread(str(tmp_path / "missing.png"))
