"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through
``data/jpeg.py`` and ``data/image_io.imread``), built here with g++,
against ``cv2.imread(path, cv2.IMREAD_COLOR)``, which the JAX package
reads frames with (cv2's bundled libjpeg-turbo). Bit for bit:

- on every committed fixture of ``tests/data/jpeg`` (``make_fixtures.py``),
  whose decoded bytes also hash to the manifest's sha256;
- on seeded images that cv2 writes here, over the samplings (4:2:0, 4:2:2,
  4:4:4, 4:4:0), gray, baseline and progressive, restart intervals,
  optimized tables, qualities and odd sizes down to 1x1;
- on Exif orientations 1-8 in both TIFF byte orders.

Each unsupported variant raises ``UnsupportedImage``; truncated and
corrupted data raise it or decode, and never crash the process; a ``.png``
name on JPEG bytes decodes by the signature; threads decode in parallel to
the same bytes."""

import hashlib
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data import image_io as io
from lowlightenvironmentvideoobjectdetection_torch.data import jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            for s in ("411", "420", "422", "440", "444")}
SIZES = [(1, 1), (2, 3), (3, 5), (8, 9), (9, 8), (16, 16), (17, 33),
         (33, 17), (24, 40)]


_pinned_threads = thread_count(1)


def texture(seed, shape):
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    base = np.linspace(0, 180, h)[:, None] + 30 * np.sin(np.arange(w) / 3.0)
    if len(shape) == 3:
        base = base[..., None] + np.array([0, 25, 50])
    return np.clip(base + rng.randint(0, 60, shape), 0, 255).astype(np.uint8)


def encode(img, quality=90, sampling="420", progressive=False, rst=0,
           optimize=False):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)])
    assert ok
    return buf.tobytes()


def same_as_cv2(path):
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = io.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_equals_cv2_and_its_manifest_hash(name):
    got = same_as_cv2(os.path.join(FIXTURES, name))
    entry = MANIFEST[name]
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


VARIANTS = {
    "baseline_420": dict(),
    "baseline_422": dict(sampling="422"),
    "baseline_444": dict(sampling="444"),
    "baseline_440": dict(sampling="440"),
    "gray": dict(gray=True),
    "progressive_420": dict(progressive=True),
    "progressive_422": dict(sampling="422", progressive=True),
    "progressive_444": dict(sampling="444", progressive=True),
    "progressive_440": dict(sampling="440", progressive=True),
    "progressive_gray": dict(gray=True, progressive=True),
    "restart_1_420": dict(rst=1),
    "restart_2_440": dict(sampling="440", rst=2),
    "restart_3_progressive_444": dict(sampling="444", rst=3,
                                      progressive=True),
    "restart_1_gray_progressive": dict(gray=True, rst=1, progressive=True),
    "optimized_422": dict(sampling="422", optimize=True),
    "quality_50": dict(quality=50),
    "quality_100_444": dict(quality=100, sampling="444"),
    "quality_100_progressive": dict(quality=100, progressive=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cv2_written_images_decode_bit_for_bit(tmp_path, variant):
    kw = dict(VARIANTS[variant])
    gray = kw.pop("gray", False)
    for seed, hw in enumerate(SIZES):
        img = texture(seed, hw if gray else hw + (3,))
        path = tmp_path / f"{seed}.jpg"
        path.write_bytes(encode(img, **kw))
        same_as_cv2(path)


def exif_app1(orientation, little_endian, prefix=b"Exif\0\0"):
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHI", 0x010F, 2, 4) + b"cam\0"
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))
    body = prefix + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation, little_endian):
    data = encode(texture(3, (16, 32, 3)), sampling="422")
    path = tmp_path / "o.jpg"
    path.write_bytes(data[:2] + exif_app1(orientation, little_endian)
                     + data[2:])
    got = same_as_cv2(path)
    assert got.shape[:2] == ((32, 16) if orientation >= 5 else (16, 32))


def test_only_an_exif_app1_orients(tmp_path):
    """cv2 takes the orientation from the APP1 that starts "Exif": an XMP
    APP1 before it does not hide it, an APP1 with another name is not
    read."""
    data = encode(texture(4, (16, 32, 3)))
    xmp = b"http://ns.adobe.com/xap/1.0/\0<x/>"
    xmp = b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp
    path = tmp_path / "x.jpg"
    path.write_bytes(data[:2] + xmp + exif_app1(6, True) + data[2:])
    assert same_as_cv2(path).shape == (32, 16, 3)
    path.write_bytes(data[:2] + exif_app1(6, True, b"Other\0") + data[2:])
    assert same_as_cv2(path).shape == (16, 32, 3)


def _scans(data):
    """Offsets of the SOS markers (FF DA never occurs in entropy data)."""
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def _unsupported(kind):
    img = texture(9, (24, 40, 3))
    data = encode(img)
    i = data.index(b"\xff\xc0")  # SOF0
    if kind == "sampling_411":
        return encode(img, sampling="411"), "sampling layout"
    if kind in ("arithmetic", "lossless", "hierarchical"):
        code = {"arithmetic": 0xC9, "lossless": 0xC3,
                "hierarchical": 0xC5}[kind]
        return data[:i + 1] + bytes([code]) + data[i + 2:], kind
    if kind == "12_bit":
        return data[:i + 4] + bytes([12]) + data[i + 5:], "12-bit"
    if kind == "cmyk":
        sof = (b"\xff\xc0" + struct.pack(">HBHHB", 20, 8, 24, 40, 4)
               + b"".join(bytes([c, 0x11, 0]) for c in range(1, 5)))
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        return data[:i] + sof + data[i + 2 + n:], "CMYK"
    if kind == "adobe_rgb":
        j = data.index(b"\xff\xe0")  # drop JFIF: then Adobe decides
        n = struct.unpack(">H", data[j + 2:j + 4])[0]
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
        return data[:j] + adobe + data[j + 2 + n:], "RGB-coded"
    if kind == "incomplete_progressive":
        prog = encode(img, progressive=True)
        return prog[:_scans(prog)[3]] + b"\xff\xd9", "block smoothing"
    raise KeyError(kind)


@pytest.mark.parametrize("kind", [
    "sampling_411", "arithmetic", "lossless", "hierarchical", "12_bit",
    "cmyk", "adobe_rgb", "incomplete_progressive"])
def test_unsupported_variants_raise(tmp_path, kind):
    data, match = _unsupported(kind)
    path = tmp_path / "u.jpg"
    path.write_bytes(data)
    with pytest.raises(io.UnsupportedImage, match="unsupported JPEG"):
        io.imread(str(path))
    with pytest.raises(jpeg.UnsupportedImage, match=match):
        jpeg.decode_jpeg(data)


@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_data_raises(progressive):
    data = encode(texture(5, (40, 56, 3)), progressive=progressive, rst=2)
    for cut in list(range(2, 700, 7)) + [len(data) - 2, len(data) - 1]:
        with pytest.raises(jpeg.UnsupportedImage,
                           match="corrupt JPEG|unsupported JPEG"):
            jpeg.decode_jpeg(data[:cut])


def test_misnumbered_restart_marker_and_bad_segment_raise():
    data = encode(texture(6, (40, 56, 3)), rst=1)
    i = data.index(b"\xff\xd1")
    bad = data[:i + 1] + b"\xd5" + data[i + 2:]
    with pytest.raises(jpeg.UnsupportedImage, match="restart marker"):
        jpeg.decode_jpeg(bad)
    j = data.index(b"\xff\xdb")
    bad = data[:j + 2] + b"\xff\xff" + data[j + 4:]
    with pytest.raises(jpeg.UnsupportedImage, match="corrupt JPEG"):
        jpeg.decode_jpeg(bad)


def test_corrupt_bytes_raise_or_decode_and_never_crash():
    data = bytearray(encode(texture(7, (40, 56, 3)), progressive=True))
    rng = np.random.RandomState(0)
    raised = 0
    for _ in range(300):
        bad = bytearray(data)
        for pos in rng.randint(2, len(bad), rng.randint(1, 6)):
            bad[pos] = rng.randint(0, 256)
        try:
            out = jpeg.decode_jpeg(bytes(bad))
            assert out.dtype == np.uint8 and out.ndim == 3
        except jpeg.UnsupportedImage:
            raised += 1
    assert raised > 0


def test_png_name_on_jpeg_bytes_decodes_by_signature(tmp_path):
    path = tmp_path / "frame.png"
    path.write_bytes(encode(texture(8, (20, 30, 3))))
    same_as_cv2(path)
    path.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(io.UnsupportedImage, match="neither PNG nor JPEG"):
        io.imread(str(path))


def test_threads_decode_in_parallel_to_the_same_bytes():
    path = os.path.join(FIXTURES, "darkfarm_0_low.jpg")
    with open(path, "rb") as f:
        data = f.read()
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(jpeg.decode_jpeg, [data] * 8))
    for out in outs:
        np.testing.assert_array_equal(out, want)


def test_darkfarm_jpeg_tree_batches_match_jax(tmp_path):
    """The canonical config's loader on ``write_darkfarm_jpeg_tree`` (two
    1080x1920 pairs, 2 frames a video) against the JAX
    ``dataset_iterator`` + ``make_batch``, which reads the .JPG frames with
    cv2: equal batches (tolerance 0), with one worker process."""
    import random

    import test_torch_port_train_cli as tc

    from lowlightenvironmentvideoobjectdetection_torch import (
        config as tconfig,
    )
    from lowlightenvironmentvideoobjectdetection_torch.data import (
        loader as tl,
    )
    from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
        loading,
    )
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_darkfarm_jpeg_tree,
    )
    from lowlightenvironmentvideoobjectdetection_tpu import config as jconfig

    ann, val = write_darkfarm_jpeg_tree(str(tmp_path), videos=2,
                                        val_videos=1, frames=2)
    assert loading.gt_sibling_path("x/video_0/low/1.JPG") == \
        "x/video_0/GT/1.JPG"
    with open(val) as f:
        assert len(json.load(f)["images"]) == 2
    opts = tc._options((f"{tmp_path}/", ann))
    seed, steps = 4, 3
    jcli = tc._jax_cli()
    jcfg = jconfig.Config.fromfile(tc.CANONICAL)
    jconfig.apply_cli_options(jcfg, opts)
    jmodel, _, _, _, make_batch = jcli.build_system(jcfg, tiny=True)
    np.random.seed(seed)
    it = jcli.dataset_iterator(jcfg, jmodel)
    want = []
    for step in range(steps):
        random.seed(tl.sample_seed(seed, step, 0))
        want.append(make_batch(next(it)))
    tcfg = tconfig.Config.fromfile(tc.CANONICAL)
    tconfig.apply_cli_options(tcfg, opts)
    loader = tl.TrainLoader(tcfg, 64, 64, 3, seed=seed, device="cpu",
                            workers=1)
    try:
        got = [next(loader) for _ in range(steps)]
    finally:
        loader.close()
    for g, w in zip(got, want):
        for name, a, b in zip(g._fields, g, w):
            a, b = a[0].numpy(), np.asarray(b)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    assert all(bool(b.gt_valid.any()) for b in got)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No g++: the first decode raises; no other decoder takes over."""
    monkeypatch.setattr(jpeg.host_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(jpeg.host_build.shutil, "which", lambda name: None)
    jpeg.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            io.imread(os.path.join(FIXTURES, "gray.jpg"))
    finally:
        jpeg.load_library.cache_clear()
