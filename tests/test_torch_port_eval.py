"""The port's evaluation loop (``apis/test.py``, the test-order loader of
``data/loader.py``, ``distributed_video_split``, ``vid_model_kwargs``)
against the JAX package's ``apis/test.py``, on the CPU.

A DarkFarm-layout tree of 2 videos x 6 PNG pairs at 96x128
(``write_darkfarm_tree``) streams through the canonical config's test
split at ``TINY_KW`` (f32, 64x64 bucket) with a 32-channel neck: the JAX
``VIDModel`` with its seeded weights, the port's with the same weights
through ``utils/jax_bridge.py``. The gts are the JAX run's own top
detections (2 a frame, in original coordinates, as
``tests/test_e2e_map_parity.py`` makes them), so the mAP is high and the
rescale, the score order and every constant of the eval path bear on it.

- ``single_device_test`` gives the same per-frame per-class results
  (boxes to 5e-3, scores to 1e-5, matched as sets) and the same gts;
  mAP50 within 1e-6;
- ``multi_device_test`` with 2 shards equals 1 shard, in dataset order;
- ``distributed_video_split`` equals JAX's over several layouts;
- each pair is decoded once a video (``imread`` calls counted);
- a fix-stride sampler config matches too;
- the loader gives identical results with 0 and 2 worker processes;
- on videos shorter than the memo (6 frames, 14 references) the
  adaptive-stride sampler repeats frames as JAX's does, and the memo keeps
  14 slots.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.apis import test as tapi
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    VIDModel as TVIDModel,
)
from lowlightenvironmentvideoobjectdetection_torch.data import (
    datasets as tds,
)
from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
    build_dataset,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    Compose as TCompose,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    loading,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_darkfarm_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
    vid_model_kwargs,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import test as japi
from lowlightenvironmentvideoobjectdetection_tpu.apis.inference import (
    VIDModel as JVIDModel,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (
    datasets as jds,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    Compose as JCompose,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(
    ROOT, "configs/vid/llvod/llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")
VIDEOS, FRAMES, HW = 2, 6, (96, 128)
GTS_PER_FRAME = 2
BOX_TOL, SCORE_TOL, MAP_TOL = 5e-3, 1e-5, 1e-6
FIX_SAMPLER = dict(method="test_with_fix_stride", frame_range=[-2, 2],
                   stride=2)


_pinned_threads = thread_count(1)


def jax_kwargs(cfg):
    """The JAX ``tools/test.py`` mapping of a darkfarm config with
    ``--tiny`` (``main``, :289-315)."""
    mcfg = dict(cfg["model"])
    mcfg.pop("type")
    mcfg.update(pad_h=64, pad_w=64, train_nms_pre=64, train_nms_post=32,
                test_nms_pre=64, test_nms_post=16, num_roi_samples=16,
                compute_dtype=jnp.float32)
    mcfg["out_indices"] = (3,)
    mcfg.pop("loss_type", None)
    in_ch = mcfg.pop("in_channels", None)
    if in_ch and in_ch != 3:
        mcfg.setdefault("backbone_in_channels", in_ch)
    for k in ("with_aggregator", "agg_rdb", "agg_taf", "dual_branch",
              "denoiser", "with_cleaner"):
        mcfg.pop(k, None)
    sampler = cfg["data"]["test"].get("ref_img_sampler") or {}
    if sampler.get("method") == "test_with_fix_stride":
        mcfg.setdefault("ref_method", "fix")
        mcfg.setdefault("frame_stride", sampler.get("stride", 1))
        fr = sampler.get("frame_range", [-7, 7])
        mcfg.setdefault("num_ref_frames",
                        abs(fr[0]) + fr[1] if isinstance(fr, list) else 14)
    return mcfg


def load_cfg(ann, prefix, sampler=None):
    cfg = tconfig.Config.fromfile(CANONICAL)
    tconfig.apply_cli_options(cfg, [f"data.test.ann_file={ann}",
                                    f"data.test.img_prefix={prefix}",
                                    "model.neck_channels=32"])
    if sampler is not None:
        cfg["data"]["test"]["ref_img_sampler"] = dict(sampler)
    return cfg


def top_detection_gts(src_ann, dst_ann, det_lists, k=GTS_PER_FRAME):
    """Rewrite ``src_ann``'s annotations as the top-``k`` detections of
    each frame (COCO xywh, original coordinates)."""
    with open(src_ann) as f:
        data = json.load(f)
    images = sorted(data["images"],
                    key=lambda im: (im["video_id"], im["frame_id"]))
    anns = []
    for img, per_cls in zip(images, det_lists):
        flat = [(c, row) for c, rows in enumerate(per_cls) for row in rows]
        flat.sort(key=lambda t: -t[1][4])
        for c, row in flat[:k]:
            x1, y1, x2, y2 = [float(x) for x in row[:4]]
            w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
            anns.append(dict(id=len(anns) + 1, image_id=img["id"],
                             video_id=img["video_id"], category_id=c + 1,
                             bbox=[x1, y1, w, h], area=w * h, iscrowd=0,
                             instance_id=len(anns) + 1))
    data["annotations"] = anns
    with open(dst_ann, "w") as f:
        json.dump(data, f)
    return dst_ann


def jax_dataset(cfg):
    d = cfg["data"]["test"]
    return jds.DarkFarmVIDDataset(
        ann_file=d["ann_file"], img_prefix=d["img_prefix"], test_mode=True,
        ref_img_sampler=dict(d["ref_img_sampler"]))


def jax_run(jmodel, cfg):
    return japi.single_device_test(jmodel, jax_dataset(cfg),
                                   JCompose(cfg["data"]["test"]["pipeline"]))


def port_model(cfg, params):
    d = cfg["data"]["test"]
    return TVIDModel(state_dict=from_jax_variables(params), device="cpu",
                     **vid_model_kwargs(cfg["model"], d["ref_img_sampler"],
                                        tiny=True))


def port_run(tmodel, cfg, **kw):
    d = cfg["data"]["test"]
    return tapi.single_device_test(
        tmodel, build_dataset(d, test_mode=True),
        TCompose(d["pipeline"], device="cpu"), **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("eval_tree"))
    src = write_darkfarm_tree(root, videos=VIDEOS, frames=FRAMES, hw=HW,
                              seed=0)
    cfg0 = load_cfg(src, root + "/")
    jmodel = JVIDModel(model_type="SELSA", **jax_kwargs(cfg0))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    jmodel.params)
    jmodel.params = params
    dets0, _ = jax_run(jmodel, cfg0)
    ann = top_detection_gts(src, os.path.join(root, "gts.json"), dets0)
    cfg = load_cfg(ann, root + "/")
    jd, ja = jax_run(jmodel, cfg)
    tmodel = port_model(cfg, params)
    td, ta = port_run(tmodel, cfg)
    return dict(root=root, cfg=cfg, params=params, tmodel=tmodel,
                jax=(jd, ja), port=(td, ta))


def same_per_class(got, want):
    """Per-class [N, 5] results equal as sets, within BOX_TOL and
    SCORE_TOL (as ``test_torch_port_selsa.py``'s ``_same_per_class``)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rows = list(g)
        for r in w:
            hits = [i for i, x in enumerate(rows)
                    if np.abs(x[:4] - r[:4]).max() < BOX_TOL
                    and abs(x[4] - r[4]) < SCORE_TOL]
            assert hits, r
            rows.pop(hits[0])


def same_anns(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_single_device_test_matches_jax(world):
    (jd, ja), (td, ta) = world["jax"], world["port"]
    assert len(td) == len(jd) == VIDEOS * FRAMES
    for got, want in zip(td, jd):
        same_per_class(got, want)
    same_anns(ta, ja)
    assert all(len(a["labels"]) == GTS_PER_FRAME for a in ta)
    got = tapi.evaluate_bbox(td, ta)
    want = japi.evaluate_bbox(jd, ja)
    assert abs(got["mAP50"] - want["mAP50"]) <= MAP_TOL
    assert got["mAP50"] > 0.9
    # another threshold names its key as JAX does
    assert set(tapi.evaluate_bbox(td, ta, 0.75)) == {"mAP75"}


def test_vid_model_kwargs_match_the_jax_cli(world):
    cfg = world["cfg"]
    tcfg = world["tmodel"].cfg
    jcfg = JVIDModel(model_type="SELSA", params=world["params"],
                     **jax_kwargs(cfg)).cfg
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("compute_dtype", "head_dtype"):
            assert (got is None) == (want is None) and (
                got is None or str(got)[6:] == jnp.dtype(want).name), f.name
        else:
            assert got == want, f.name
    assert (tcfg.roi_extractor, tcfg.num_shared_fcs, tcfg.num_classes) == (
        "temporal", 3, 8)


def test_multi_device_test_shards_equal_one(world):
    td, ta = world["port"]
    cfg = world["cfg"]
    d = cfg["data"]["test"]
    ds = build_dataset(d, test_mode=True)
    pipe = TCompose(d["pipeline"], device="cpu")
    got, anns, idx = tapi.multi_device_test(world["tmodel"], ds, pipe,
                                            num_shards=2)
    assert idx == list(range(len(ds)))
    for g, w in zip(got, td):  # td: the whole split as one shard
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    same_anns(anns, ta)
    one, _, idx = tapi.multi_device_test(world["tmodel"], ds, pipe,
                                         num_shards=2, shard=1)
    assert idx == list(range(FRAMES, 2 * FRAMES))
    for g, w in zip(one, td[FRAMES:]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


LAYOUTS = {"even": [4, 4, 4, 4], "uneven": [3, 1, 5, 2, 1], "one": [6],
           "singles": [1, 1, 1], "long_first": [9, 2, 2]}


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distributed_video_split_matches_jax(layout, shards):
    infos = [dict(frame_id=f) for n in LAYOUTS[layout] for f in range(n)]
    got = tds.distributed_video_split(infos, shards)
    assert got == jds.distributed_video_split(infos, shards)
    assert sum(got, []) == list(range(len(infos)))
    for part in got:  # whole videos
        assert not part or infos[part[0]]["frame_id"] == 0


def test_each_pair_decoded_once_a_video(world, monkeypatch):
    calls = []
    real = loading.imread

    def counting(path, *a, **k):
        calls.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(loading, "imread", counting)
    td, _ = port_run(world["tmodel"], world["cfg"])
    # the noisy frame and its clean sibling, once each a frame
    assert len(calls) == 2 * VIDEOS * FRAMES
    assert len(set(calls)) == len(calls)
    for g, w in zip(td, world["port"][0]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_loader_workers_give_identical_results(world):
    timings = []
    td, ta = port_run(world["tmodel"], world["cfg"], workers=2,
                      timings=timings)
    for g, w in zip(td, world["port"][0]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    same_anns(ta, world["port"][1])
    assert [t["index"] for t in timings] == list(range(VIDEOS * FRAMES))
    # frame 0 decodes the video (every frame is among its references)
    assert all(timings[v * FRAMES]["host_ms"] > 0 for v in range(VIDEOS))
    assert all(t["host_ms"] == 0 for i, t in enumerate(timings)
               if i % FRAMES)


def test_fix_stride_sampler_matches_jax(world):
    d = world["cfg"]["data"]["test"]
    cfg = load_cfg(d["ann_file"], d["img_prefix"], FIX_SAMPLER)
    kw = vid_model_kwargs(cfg["model"], FIX_SAMPLER, tiny=True)
    assert (kw["ref_method"], kw["frame_stride"], kw["num_ref_frames"]) == (
        "fix", 2, 4)
    jmodel = JVIDModel(model_type="SELSA", params=world["params"],
                       **jax_kwargs(cfg))
    jd, ja = jax_run(jmodel, cfg)
    td, ta = port_run(port_model(cfg, world["params"]), cfg)
    for got, want in zip(td, jd):
        same_per_class(got, want)
    same_anns(ta, ja)
    assert abs(tapi.evaluate_bbox(td, ta)["mAP50"]
               - japi.evaluate_bbox(jd, ja)["mAP50"]) <= MAP_TOL


def test_adaptive_stride_on_short_videos(world):
    d = world["cfg"]["data"]["test"]
    sampler = d["ref_img_sampler"]
    assert sampler["num_ref_imgs"] == 14 > FRAMES
    jd = jax_dataset(world["cfg"])
    td = build_dataset(d, test_mode=True)
    for i in (0, FRAMES):
        want = jd[i]["ref_img_infos"]
        got = td[i]["ref_img_infos"]
        assert got == want and len(got) == 14
        # 6 frames spread over 14 slots: each frame at least twice
        ids = [r["frame_id"] for r in got]
        assert sorted(set(ids)) == list(range(FRAMES))
    assert jd[1].get("ref_img_infos") == td[1].get("ref_img_infos") == []
    st = world["tmodel"].state
    assert st.ref_valid.shape[0] == 14 and st.ref_maps.shape[0] == 14
