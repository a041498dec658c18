"""The port's data pipeline steps (``data/pipelines``) against the JAX
package's, on the same numpy inputs made from a seed, on the CPU. All
comparisons are exact (tolerance 0):

- ``resize_linear_u8`` equals ``cv2.resize(..., INTER_LINEAR)`` on uint8
  with 1 to 8 channels, down, up and by exactly half, and ``Resize`` the
  JAX step (images, boxes, ``scale_factor``, shapes);
- ``numpy_float32_sum`` equals numpy's float32 ``sum`` on sizes across the
  8192-element buffer and the 128-element runs, so ``Brighten`` (single
  image, pair, clip) gives the JAX step's amplification and pixels;
- flips with boxes under equal seeds, ``Pad``, ``NormalizePairs`` on a
  pair, ``NormalizeRAW``, and the three formatting steps;
- the whole ``train_pipeline`` and ``test_pipeline`` of the canonical
  config (``llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py``) on clips
  of PNG pairs in ``tmp_path``, key by key.
"""

import copy
import random

import cv2
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.config import (
    load_config as t_load_config,
)
from lowlightenvironmentvideoobjectdetection_torch.data import (
    datasets as tds,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    Compose as TCompose,
    formatting as tfmt,
    transforms as tt,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_darkfarm_tree,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import datasets as jds
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    Compose as JCompose,
    formatting as jfmt,
    transforms as jt,
)

CANONICAL = ("configs/vid/llvod/"
             "llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")


def assert_same(j, t, path="results"):
    """JAX results (numpy, Python values) == port results (tensors, Python
    values), exactly, dtypes included."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (
            path, set(t) ^ set(j))
        for k in j:
            assert_same(j[k], t[k], f"{path}.{k}")
    elif isinstance(j, np.ndarray):
        got = (t.cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t, j.dtype))
        assert got.dtype == j.dtype and got.shape == j.shape, (
            path, got.dtype, j.dtype, got.shape, j.shape)
        np.testing.assert_array_equal(got, j, err_msg=path)
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and isinstance(t, torch.Tensor):
        # Brighten's level: a Python float in JAX, applied as float32
        assert np.float32(j) == t.item(), path
    else:
        assert t == j, (path, t, j)


def _frame(seed, hw, channels, dark=False):
    rng = np.random.RandomState(seed)
    hi = 40 if dark else 256
    return rng.randint(0, hi, hw + (channels,)).astype(np.uint8)


RESIZE_CASES = [((1080, 1920), (563, 1000), c) for c in (3, 6)] + [
    (hw, out, c)
    for hw, out in (((48, 80), (600, 1000)), ((37, 53), (61, 89)),
                    ((37, 53), (20, 29)), ((100, 100), (50, 50)),
                    ((64, 90), (32, 45)))
    for c in (1, 2, 3, 4, 5, 6, 8)]


@pytest.mark.parametrize("hw,out,channels", RESIZE_CASES)
def test_resize_linear_u8_equals_cv2(hw, out, channels):
    """Down, up, and exactly half (where cv2 averages 2 x 2 blocks)."""
    img = _frame(channels, hw, channels)
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_LINEAR
                      ).reshape(out + (channels,))
    got = tt.resize_linear_u8(torch.from_numpy(img), *out).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_linear_u8_random_shapes():
    rng = np.random.RandomState(9)
    for trial in range(60):
        h, w = rng.randint(1, 120, 2)
        nh, nw = rng.randint(1, 200, 2)
        c = (3, 6)[trial % 2]
        img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        want = cv2.resize(img, (int(nw), int(nh)),
                          interpolation=cv2.INTER_LINEAR).reshape(nh, nw, c)
        got = tt.resize_linear_u8(torch.from_numpy(img), nh, nw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, nh, nw)))


def _results(img, boxes):
    return dict(img=img, img_fields=["img"], bbox_fields=["gt_bboxes"],
                gt_bboxes=boxes, img_shape=img.shape[:2],
                gt_labels=np.arange(len(boxes), dtype=np.int64))


def _port(results):
    out = dict(results)
    for k in ("img", "gt_bboxes", "gt_labels"):
        out[k] = torch.from_numpy(np.ascontiguousarray(results[k]))
    return out


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("hw", [(90, 160), (700, 500)])
def test_resize_step(hw, channels):
    img = _frame(1, hw, channels)
    boxes = np.random.RandomState(2).uniform(0, 80, (5, 4)).astype(np.float32)
    j = jt.SeqResize(img_scale=(1000, 600))([_results(img, boxes)])
    t = tt.SeqResize(img_scale=(1000, 600))([_port(_results(img, boxes))],
                                            random.Random(0))
    assert_same(j, t)


@pytest.mark.parametrize("n", [1, 7, 8, 100, 128, 129, 1000, 8191, 8192,
                               8193, 20000, 3 * 8192 + 1, 563 * 1000 * 3])
def test_numpy_float32_sum(n):
    rng = np.random.RandomState(n % 1000)
    x = rng.randint(0, rng.randint(1, 256), n).astype(np.float32) / 255.0
    assert tt.numpy_float32_sum(torch.from_numpy(x)).item() == x.sum()


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("m", [0.25, 0.5])
def test_brighten(channels, m):
    img = _frame(3, (123, 201), channels, dark=True)
    j = jt.Brighten(m=m)(dict(img=img, img_fields=["img"]))
    t = tt.Brighten(m=m)(dict(img=torch.from_numpy(img), img_fields=["img"]))
    assert_same(j, t)
    # the clip shares the key frame's level
    clip = [_frame(s, (77, 90), channels, dark=True) for s in (4, 5, 6)]
    j = jt.SeqBrighten(m=m)([dict(img=c, img_fields=["img"]) for c in clip])
    t = tt.SeqBrighten(m=m)([dict(img=torch.from_numpy(c),
                                  img_fields=["img"]) for c in clip])
    assert_same(j, t)


@pytest.mark.parametrize("share", [True, False])
def test_flip_with_boxes(share):
    rng = np.random.RandomState(7)
    clips = [[_results(_frame(s, (40, 64), 6),
                       rng.uniform(0, 40, (3, 4)).astype(np.float32))
              for s in range(3)] for _ in range(6)]
    for seed, clip in enumerate(clips):
        random.seed(seed)
        j = jt.SeqRandomFlip(share_params=share)(copy.deepcopy(clip))
        t = tt.SeqRandomFlip(share_params=share)(
            [_port(r) for r in clip], random.Random(seed))
        assert_same(j, t)
    random.seed(11)
    j = jt.RandomFlip(flip_ratio=0.7)(copy.deepcopy(clips[0][0]))
    t = tt.RandomFlip(flip_ratio=0.7)(_port(clips[0][0]), random.Random(11))
    assert_same(j, t)


@pytest.mark.parametrize("kw", [dict(size_divisor=16), dict(size_divisor=32),
                                dict(size=(64, 96))])
def test_pad(kw):
    img = _frame(8, (45, 70), 6)
    j = jt.SeqPad(**kw)([dict(img=img, img_fields=["img"])])
    t = tt.SeqPad(**kw)([dict(img=torch.from_numpy(img), img_fields=["img"])])
    assert_same(j, t)


@pytest.mark.parametrize("channels", [3, 6])
def test_normalize(channels):
    img = _frame(9, (31, 45), channels)
    j = jt.SeqNormalize()([dict(img=img, img_fields=["img"])])
    t = tt.SeqNormalize()([dict(img=torch.from_numpy(img),
                                img_fields=["img"])])
    assert_same(j, t)


def test_normalize_raw():
    img = np.random.RandomState(10).uniform(0, 1, (20, 30, 8)
                                            ).astype(np.float32)
    kw = dict(mean=[0.25] * 4, std=[0.12] * 4)
    j = jt.SeqNormalizeRAW(**kw)(dict(img=img, img_fields=["img"]))
    t = tt.SeqNormalizeRAW(**kw)(dict(img=torch.from_numpy(img),
                                      img_fields=["img"]))
    assert_same(j, t)


def test_formatting():
    rng = np.random.RandomState(12)

    def clip(to_t):
        out = []
        for i in range(3):
            n = i + 1
            r = dict(img=rng.uniform(-2, 2, (16, 24, 6)).astype(np.float32),
                     gt_bboxes=rng.uniform(0, 20, (n, 4)).astype(np.float32),
                     gt_labels=rng.randint(0, 8, n).astype(np.int64),
                     img_shape=(16, 24), flip=bool(i % 2),
                     img_info=dict(frame_id=i, video_id=3, filename=f"{i}"))
            if to_t:
                for k in ("img", "gt_bboxes", "gt_labels"):
                    r[k] = torch.from_numpy(r[k])
            out.append(r)
        return out

    state = rng.get_state()
    jclip = clip(False)
    rng.set_state(state)
    tclip = clip(True)
    keys = ["img", "gt_bboxes", "gt_labels"]
    j = jfmt.VideoCollect(keys=keys)(jclip)
    t = tfmt.VideoCollect(keys=keys)(tclip)
    assert_same(j, t)
    j, t = jfmt.ConcatVideoReferences()(j), tfmt.ConcatVideoReferences()(t)
    assert_same(j, t)
    assert_same(jfmt.SeqDefaultFormatBundle()(j),
                tfmt.SeqDefaultFormatBundle()(t))


@pytest.fixture(scope="module")
def darkfarm_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("darkfarm")
    ann = write_darkfarm_tree(str(root), videos=2, frames=7, hw=(90, 160),
                              seed=3)
    return str(root) + "/", ann


def _clip(ds, s):
    frames = [dict(img_info=s["img_info"], ann=s["ann"],
                   img_prefix=ds.img_prefix)]
    for r, a in zip(s.get("ref_img_infos", []), s.get("ref_anns", [])):
        frames.append(dict(img_info=r, ann=a, img_prefix=ds.img_prefix))
    return frames


def test_canonical_train_pipeline(darkfarm_tree):
    prefix, ann = darkfarm_tree
    cfg = t_load_config(CANONICAL)
    dcfg = cfg["data"]["train"]
    sampler = dict(dcfg["ref_img_sampler"])
    jd = jds.DarkFarmVIDDataset(ann, img_prefix=prefix,
                                ref_img_sampler=sampler)
    td = tds.DarkFarmVIDDataset(ann, img_prefix=prefix,
                                ref_img_sampler=sampler)
    jp, tp = JCompose(dcfg["pipeline"]), TCompose(dcfg["pipeline"])
    flips = set()
    for idx in range(len(jd)):
        random.seed(idx)
        want = jp(_clip(jd, jd[idx]))
        rng = random.Random(idx)
        got = tp(_clip(td, td.get_sample(idx, rng)), rng)
        assert_same(want, got)
        assert got["img"].shape == (576, 1008, 6)
        assert got["ref_img"].shape == (2, 576, 1008, 6)
        flips.add(got["img_metas"]["flip"])
    assert flips == {True, False}


def test_canonical_test_pipeline(darkfarm_tree):
    prefix, ann = darkfarm_tree
    cfg = t_load_config(CANONICAL)
    pipeline = cfg["data"]["test"]["pipeline"]
    jp, tp = JCompose(pipeline), TCompose(pipeline)
    jd = jds.DarkFarmVIDDataset(ann, img_prefix=prefix, test_mode=True)
    for idx in (0, 5, 9):
        info = jd.data_infos[idx]
        want = jp(dict(img_info=dict(info), img_prefix=prefix))
        got = tp(dict(img_info=dict(info), img_prefix=prefix))
        assert_same(want, got)
