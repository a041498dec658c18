"""Write the committed JPEG fixtures of the port's decoder tests with cv2
(libjpeg-turbo), and ``manifest.json``: for each file its variant, the
shape and the sha256 of ``cv2.imread(path, cv2.IMREAD_COLOR)``'s bytes, and
for the DarkFarm frame pairs the boxes drawn into them.

    python tests/data/jpeg/make_fixtures.py

The variants: baseline at 4:2:0, 4:2:2, 4:4:4 and 4:4:0 (cv2's
``IMWRITE_JPEG_SAMPLING_FACTOR_440``: luma 1x2, chroma 1x1), gray,
progressive, restart intervals, optimized Huffman tables, odd sizes,
qualities 50 / 90 / 100, Exif orientations 2-8 in both TIFF byte orders
(an APP1 segment spliced in after SOI), and two 1080x1920 low / GT pairs
that ``data/synthetic.py::write_darkfarm_jpeg_tree`` copies into a DarkFarm
tree. Rerunning it with another cv2 may write other bytes; the tests
compare against the cv2 at hand, the manifest against the cv2 that wrote
the files.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            for s in ("420", "422", "444", "440")}
PAIR_HW = (1080, 1920)


def texture(seed, shape):
    """Noise over a vertical ramp and a horizontal wave: every block has
    AC energy, and chroma differs from luma."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    ramp = np.linspace(0, 180, h)[:, None]
    wave = 30 * np.sin(np.arange(w) / 3.0)[None, :]
    base = ramp + wave
    if len(shape) == 3:
        base = base[..., None] + np.array([0, 25, 50])[:shape[2]]
    return np.clip(base + rng.randint(0, 50, shape), 0, 255).astype(np.uint8)


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


def exif_app1(orientation, little_endian):
    """An APP1 "Exif" segment whose IFD0 holds only the orientation."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(jpeg, orientation, little_endian):
    return jpeg[:2] + exif_app1(orientation, little_endian) + jpeg[2:]


def pair_boxes(seed):
    """Four boxes (x, y, w, h, class id 1-8) of a DarkFarm frame pair."""
    rng = np.random.RandomState(100 + seed)
    h, w = PAIR_HW
    out = []
    for _ in range(4):
        bw, bh = rng.randint(w // 20, w // 5), rng.randint(h // 20, h // 5)
        out.append([int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh)),
                    int(bw), int(bh), int(rng.randint(1, 9))])
    return out


def pair_frames(seed, boxes):
    """A bright clean frame (a gradient, stripes and filled boxes) and its
    dark copy (an eighth of the signal plus a little smooth noise)."""
    h, w = PAIR_HW
    gt = np.empty((h, w, 3), np.uint8)
    gt[:] = np.linspace(60, 200, w).astype(np.uint8)[None, :, None]
    gt[::16] += 20
    for x, y, bw, bh, c in boxes:
        gt[y:y + bh, x:x + bw] = ((30 * c) % 256, (70 * c) % 256, 90)
    rng = np.random.RandomState(200 + seed)
    noise = cv2.resize(rng.randint(0, 6, (h // 16, w // 16, 1)).astype(
        np.uint8), (w, h), interpolation=cv2.INTER_NEAREST)
    low = gt // 8 + noise[..., None]
    return low, gt


def fixtures():
    """name -> (variant, JPEG bytes, extra manifest fields)."""
    out = {}
    img = texture(0, (48, 64, 3))
    for s in SAMPLING:
        out[f"baseline_{s}.jpg"] = (f"baseline {s}", encode(img, sampling=s),
                                    {})
    out["gray.jpg"] = ("gray", encode(texture(1, (40, 56))), {})
    out["progressive_420.jpg"] = ("progressive 420",
                                  encode(img, progressive=True), {})
    out["progressive_444.jpg"] = (
        "progressive 444", encode(texture(2, (33, 47, 3)), sampling="444",
                                  progressive=True), {})
    out["progressive_gray.jpg"] = (
        "progressive gray", encode(texture(3, (29, 41)), progressive=True),
        {})
    out["restart_420.jpg"] = ("restart interval 1",
                              encode(img, rst=1), {})
    out["restart_progressive_422.jpg"] = (
        "restart interval 3, progressive 422",
        encode(texture(4, (40, 72, 3)), sampling="422", progressive=True,
               rst=3), {})
    out["optimized_420.jpg"] = ("optimized Huffman tables",
                                encode(img, optimize=True), {})
    for hw in [(17, 33), (1, 1), (8, 9), (9, 8), (3, 5)]:
        name = f"odd_{hw[0]}x{hw[1]}.jpg"
        out[name] = (f"odd size {hw[0]}x{hw[1]} 420",
                     encode(texture(5, hw + (3,))), {})
    for q in (50, 90, 100):
        out[f"quality_{q}.jpg"] = (f"quality {q}",
                                   encode(texture(6, (40, 48, 3)), q), {})
    small = encode(texture(7, (16, 24, 3)))
    for o in range(2, 9):
        for le, order in ((True, "ii"), (False, "mm")):
            out[f"exif_{o}_{order}.jpg"] = (
                f"Exif orientation {o} ({order.upper()})",
                with_exif(small, o, le), {})
    for k in range(2):
        boxes = pair_boxes(k)
        low, gt = pair_frames(k, boxes)
        out[f"darkfarm_{k}_low.jpg"] = ("1080x1920 420 low",
                                        encode(low, 85), {"boxes": boxes})
        out[f"darkfarm_{k}_gt.jpg"] = ("1080x1920 420 GT",
                                       encode(gt, 85), {"boxes": boxes})
    return out


def main():
    manifest = {}
    for name, (variant, data, extra) in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        manifest[name] = dict(variant=variant, shape=list(img.shape),
                              sha256=hashlib.sha256(img.tobytes()).hexdigest(),
                              **extra)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
