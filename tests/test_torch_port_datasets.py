"""The port's COCO-VID index and video datasets (``data/coco_vid.py``,
``data/datasets.py``) against the JAX package's on one synthetic
annotation file: crowd, ignored, sub-pixel and unknown-category boxes,
frames without boxes and frames that are not training frames, videos of
1 to 23 frames. ``CocoVID``'s tables, ``data_infos``, every
``get_ann_info`` and every reference-frame sampling method give identical
ids and arrays, with the port's ``random.Random`` seeded as the JAX side's
(its own or Python's global one)."""

import json
import random

import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data import (
    coco_vid as tcoco,
    datasets as tds,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (
    coco_vid as jcoco,
    datasets as jds,
)

VIDEO_LENGTHS = (1, 2, 7, 23)


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def ann_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    names = list(jds.DARKFARM_CLASSES) + ["tractor"]
    d = dict(videos=[], images=[], annotations=[],
             categories=[dict(id=i + 1, name=n) for i, n in enumerate(names)])
    for v, n in enumerate(VIDEO_LENGTHS):
        d["videos"].append(dict(id=v + 1, name=f"v{v}"))
        order = rng.permutation(n)  # images listed out of frame order
        for f in order:
            img_id = len(d["images"]) + 1
            d["images"].append(dict(
                id=img_id, video_id=v + 1, frame_id=int(f),
                file_name=f"v{v}/low/{f:06d}.png", width=64, height=48,
                is_vid_train_frame=bool(f % 5 != 4)))
            for _ in range(rng.randint(0, 4)):  # some frames have none
                w, h = rng.uniform(0.5, 30, 2)
                d["annotations"].append(dict(
                    id=len(d["annotations"]) + 1, image_id=img_id,
                    video_id=v + 1, category_id=int(rng.randint(1, 10)),
                    instance_id=int(rng.randint(1, 4)),
                    bbox=[float(rng.uniform(0, 30)),
                          float(rng.uniform(0, 20)), float(w), float(h)],
                    iscrowd=bool(rng.rand() < 0.15),
                    ignore=bool(rng.rand() < 0.1)))
    path = tmp_path_factory.mktemp("ann") / "ann.json"
    path.write_text(json.dumps(d))
    return str(path)


def test_coco_vid_tables(ann_file):
    j, t = jcoco.CocoVID(ann_file), tcoco.CocoVID(ann_file)
    assert t.get_vid_ids() == j.get_vid_ids()
    assert t.get_img_ids() == j.get_img_ids()
    assert t.get_cat_ids() == j.get_cat_ids()
    assert t.get_cat_ids(["cow", "duck", "nope"]) == j.get_cat_ids(
        ["cow", "duck", "nope"])
    assert t.get_ins_ids() == j.get_ins_ids()
    for v in j.get_vid_ids():
        ids = j.get_img_ids_from_vid(v)
        assert t.get_img_ids_from_vid(v) == ids
        assert t.get_ann_ids(ids) == j.get_ann_ids(ids)
        assert t.load_imgs(ids) == j.load_imgs(ids)


@pytest.mark.parametrize("cls", ["DarkFarmVIDDataset", "ImagenetVIDDataset"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_data_infos_and_annotations(ann_file, cls, test_mode):
    j = getattr(jds, cls)(ann_file, img_prefix="root/", test_mode=test_mode)
    t = getattr(tds, cls)(ann_file, img_prefix="root/", test_mode=test_mode)
    assert len(t) == len(j) > 0
    assert t.data_infos == j.data_infos
    assert t.cat2label == j.cat2label
    kept = 0
    for info in j.coco.imgs.values():
        want, got = j.get_ann_info(info), t.get_ann_info(info)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        kept += len(want["labels"])
    # the filters dropped some boxes (crowd, ignore, < 1 px, tractor)
    assert 0 < kept < len(j.coco.anns)


SAMPLERS = [
    dict(method="uniform", frame_range=3, num_ref_imgs=2),
    dict(method="uniform", frame_range=[-1, 1], num_ref_imgs=4),
    dict(method="uniform", frame_range=5, num_ref_imgs=3,
         filter_key_img=False, keep_samples_length=False),
    dict(method="bilateral_uniform", frame_range=9, num_ref_imgs=2),
    dict(method="bilateral_uniform", frame_range=[-2, 4], num_ref_imgs=6),
    dict(method="test_with_adaptive_stride", frame_range=[-7, 7],
         num_ref_imgs=14),
    dict(method="test_with_fix_stride", frame_range=[-2, 3], stride=2,
         num_ref_imgs=1),
    dict(method="uniform", frame_range=0, num_ref_imgs=2),
]


@pytest.mark.parametrize("sampler", range(len(SAMPLERS)))
def test_ref_img_sampling(ann_file, sampler):
    kw = SAMPLERS[sampler]
    test_mode = kw["method"].startswith("test")
    j = jds.DarkFarmVIDDataset(ann_file, ref_img_sampler=kw,
                               test_mode=test_mode)
    t = tds.DarkFarmVIDDataset(ann_file, ref_img_sampler=kw,
                               test_mode=test_mode)
    for idx in range(len(j)):
        for seed in (idx, 1000 + idx):
            info_j, info_t = dict(j.data_infos[idx]), dict(t.data_infos[idx])
            want = j.ref_img_sampling(info_j, **kw, rng=random.Random(seed))
            got = t.ref_img_sampling(info_t, **kw, rng=random.Random(seed))
            assert [r["id"] for r in got] == [r["id"] for r in want]
            assert got == want and info_t == info_j


@pytest.mark.parametrize("sampler", [0, 3, 4])
def test_getitem_with_the_global_generator(ann_file, sampler):
    """The JAX ``__getitem__`` draws from Python's global generator; the
    port's ``get_sample`` from the generator it is given, in that state."""
    kw = SAMPLERS[sampler]
    j = jds.DarkFarmVIDDataset(ann_file, ref_img_sampler=kw)
    t = tds.DarkFarmVIDDataset(ann_file, ref_img_sampler=kw)
    for idx in range(len(j)):
        random.seed(idx)
        want = j[idx]
        got = t.get_sample(idx, random.Random(idx))
        assert got["img_info"] == want["img_info"]
        assert got["ref_img_infos"] == want["ref_img_infos"]
        for a, b in zip(got["ref_anns"] + [got["ann"]],
                        want["ref_anns"] + [want["ann"]]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    # dataset[idx] draws from the dataset's own generator
    t.rng = random.Random(3)
    random.seed(3)
    assert t[0]["ref_img_infos"] == j[0]["ref_img_infos"]
