"""The rest of the one-stage zoo in the port against the JAX package on the
CPU: FSAF, FoveaBox, SABL, RepPoints and NAS-FPN RetinaNet at the JAX
CLI's ``--tiny`` sizes (128 x 128, f32, 4 classes; NAS-FPN 2 stacks;
``torch_port_variant_cases``), and their parts on numpy inputs drawn from
a seed. Here FSAF, FoveaBox and SABL and the assigners; RepPoints,
NAS-FPN RetinaNet and the rest in ``test_torch_port_zoo_heads_c_b.py``:

- each family: both names build where it has two, the head's per-level
  outputs on P3-P7, every loss term and every gradient leaf, and the
  detections as sets;
- ``point_assign`` and ``center_region_assign`` exactly, on grids where
  distances and areas tie;
- SABL's ``bbox2bucket`` with gt sides midway between buckets and
  ``bucket2bbox`` with tied bucket probabilities (``top_k_stable``);
- the test CLI's image route on this slice's six configs (the five
  families' and the AutoAugment RetinaNet's) with ``--tiny`` on a seeded
  COCO tree: every image, 80 per-class lists, finite, mAP50 in [0, 1].

Tolerances as ``torch_port_variant_cases``: features to 1e-4 of their
largest value, losses to 1e-5 relative, gradients to 1e-4 of each leaf's
largest value, detections as sets (boxes to 5e-3 px, scores to 1e-5);
assignments and targets exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_variant_cases as C
from test_torch_port_dense_families import (
    head_outputs_match,
    loss_terms_and_gradients_match,
)

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.core import (
    assigners as TA,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_coco_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    fsaf_head as TFS,
    sabl_head as TSB,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    test as tcli,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    assigners as JA,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    reppoints_head as JRP,
    sabl_head as JSB,
)
from torch_port_threads import thread_count

FAMILIES = ("FSAF", "FoveaBox", "SABL")
SECOND_NAME = {"FoveaBox": "FOVEA", "SABL": "SABLRetinaNet",
               "RepPoints": "RepPointsDetector"}
TERMS = {"FSAF": ("loss_cls", "loss_bbox"),
         "FoveaBox": ("loss_cls", "loss_bbox"),
         "SABL": ("loss_cls", "loss_bbox_cls", "loss_bbox_reg"),
         "RepPoints": ("loss_cls", "loss_pts_init", "loss_pts_refine"),
         "NASFPNRetinaNet": ("loss_cls", "loss_bbox")}
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("fsaf_r50_fpn_1x_coco.py", "fovea_r50_fpn_4x4_1x_coco.py",
           "sabl_retinanet_r50_fpn_1x_coco.py",
           "reppoints_moment_r50_fpn_1x_coco.py",
           "retinanet_r50_nasfpn_crop640_50e_coco.py",
           "retinanet_r50_fpn_autoaugment_1x_coco.py")


def t(a):
    return torch.from_numpy(np.asarray(a))


# the weights' seed: 5 (``C.built``'s default) save for SABL, whose come
# from seed 6: at seed 5 a ReLU of its classification tower (the second
# conv's output at channel 4, cell (3, 1) of P3) is 2.85e-6 from its kink,
# and the two frameworks take its gradient on different sides (138 leaves
# outside the tolerance, none once ``tests/relu_kinks.py``'s flip of that
# element is applied); seeds 6, 7 and 8 agree
SEED = {"SABL": 6}


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    return name, C.built(name, SEED.get(name, 5))


def both_names_build(name):
    f = TF.get_family(name)
    for n in (name, SECOND_NAME.get(name, name)):
        assert TF.get_family(n) is f
        assert n not in TF.NOT_PORTED
    m, _ = f.build(dict(C.MCFG), True, 0, "cpu")
    assert m.num_classes == 4
    assert TF.pad_hw(m, f, True) == (128, 128)
    assert TF.pad_hw(m, f, False) == TF.DENSE_PAD_HW
    if name == "NASFPNRetinaNet":  # the JAX --tiny: 2 stacks
        assert m.neck.stack_times == 2
        full, _ = f.build(dict(C.MCFG), False, 0, "cpu")
        assert full.neck.stack_times == 7


@pytest.mark.parametrize("name", FAMILIES)
def test_both_names_build(name):
    both_names_build(name)


def test_head_outputs_match_jax(fam):
    head_outputs_match(fam[1])


def test_loss_terms_and_gradients_match_jax(fam):
    name, built = fam
    met = loss_terms_and_gradients_match(built)
    assert set(met) == set(TERMS[name]) | {"loss"}
    for k in TERMS[name]:
        assert met[k] > 0, k
    if name == "RepPoints":  # the points carry a gradient through the DCNs
        head = built[5].bbox_head
        for mod in ("reppoints_cls_conv", "reppoints_pts_refine_conv",
                    "reppoints_pts_init_out"):
            assert float(getattr(head, mod).weight.grad.abs().max()) > 0, mod


def test_detections_match_jax(fam):
    C.same_detections(*fam[1])


# ---------------------------------------------------------------------------
# assigners
# ---------------------------------------------------------------------------

def _rep_points():
    pts = np.concatenate([np.asarray(c) for c in JRP._centers(SIZES)])
    lvl = np.concatenate([np.full(h * w, i + 3, np.int32)
                          for i, (h, w) in enumerate(SIZES)])
    return pts, lvl


def test_point_assign_ties_match_jax():
    """Gt centres midway between grid points (distances tie: the lower
    point index wins), two gts claiming the same point (the nearer keeps
    it), a gt too small for any level (clamped to P3), a padded gt."""
    pts, lvl = _rep_points()
    gts = np.array([[4.0, 4.0, 36.0, 36.0],      # centre (20, 20), P3
                    [8.0, 8.0, 32.0, 32.0],      # centre (20, 20) again
                    [24.0, 0.0, 56.0, 40.0],     # centre (40, 20)
                    [0.0, 0.0, 128.0, 112.0],    # a large one, P5
                    [30.0, 30.0, 31.0, 31.0],    # tiny: clamped to P3
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    labels = np.array([1, 2, 3, 0, 2, 0])
    valid = np.array([True, True, True, True, True, False])
    want = JA.point_assign(jnp.asarray(pts), jnp.asarray(lvl),
                           jnp.asarray(gts), jnp.asarray(labels),
                           jnp.asarray(valid))
    got = TA.point_assign(t(pts), t(lvl).long(), t(gts), t(labels).long(),
                          t(valid))
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(want.assigned_gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    a = got.assigned_gt_inds.numpy()
    # gts 0 and 1 claim the same P3 point; gt 0 is nearer relative to its
    # size and keeps it
    assert set(a[a > 0]) == {1, 3, 4, 5}
    # the ties are real: four P3 points are equally near (20, 20)
    p3 = pts[:256]
    d = np.hypot(p3[:, 0] - 20.0, p3[:, 1] - 20.0)
    assert (d == d.min()).sum() == 4


@pytest.mark.parametrize("pos_num", [1, 3])
def test_point_assign_pos_num_matches_jax(pos_num):
    pts, lvl = _rep_points()
    rs = np.random.RandomState(11)
    xy = rs.randint(0, 100, (8, 2)).astype(np.float32)
    wh = rs.randint(4, 60, (8, 2)).astype(np.float32)
    gts = np.concatenate([xy, xy + wh], 1)
    labels = rs.randint(0, 4, 8)
    valid = rs.rand(8) < 0.8
    want = JA.point_assign(jnp.asarray(pts), jnp.asarray(lvl),
                           jnp.asarray(gts), jnp.asarray(labels),
                           jnp.asarray(valid), pos_num=pos_num)
    got = TA.point_assign(t(pts), t(lvl).long(), t(gts), t(labels).long(),
                          t(valid), pos_num=pos_num)
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(want.assigned_gt_inds))


def _fsaf_anchors():
    out = []
    for (h, w), s in zip(SIZES, TFS.FSAF_STRIDES):
        px, py = TFS._centers(h, w, float(s))
        out.append(torch.stack([px - s / 2, py - s / 2, px + s / 2,
                                py + s / 2], -1))
    return torch.cat(out).numpy()


def test_center_region_assign_matches_jax():
    """Overlapping gts of equal area (the stable sort ranks the lower
    index first, so the higher wins), a smaller gt inside a larger one of
    the same class (its shadow demotes the larger's positives) and of
    another class, a padded gt."""
    anchors = _fsaf_anchors()
    gts = np.array([[8.0, 8.0, 72.0, 72.0],     # area 4096
                    [24.0, 24.0, 88.0, 88.0],   # area 4096, overlaps gt 0
                    [0.0, 64.0, 120.0, 128.0],  # large
                    [36.0, 84.0, 68.0, 116.0],  # inside gt 2, same class
                    [80.0, 70.0, 100.0, 90.0],  # inside gt 2, other class
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    labels = np.array([1, 2, 3, 3, 0, 0])
    valid = np.array([True] * 5 + [False])
    jar, jsh = JA.center_region_assign(
        jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(labels),
        jnp.asarray(valid), 0.2, 0.2)
    tar, tsh = TA.center_region_assign(t(anchors), t(gts), t(labels).long(),
                                       t(valid), 0.2, 0.2)
    np.testing.assert_array_equal(tar.assigned_gt_inds.numpy(),
                                  np.asarray(jar.assigned_gt_inds))
    np.testing.assert_array_equal(tar.labels.numpy(), np.asarray(jar.labels))
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    a = tar.assigned_gt_inds.numpy()
    # gt 3's positives lie in the shadow of gt 2, of its class: demoted
    assert set(a[a > 0]) == {1, 2, 3, 5} and tsh.any()


# ---------------------------------------------------------------------------
# SABL's buckets
# ---------------------------------------------------------------------------

def test_sabl_buckets_with_ties_match_jax():
    """Gt sides exactly midway between two bucket centres (|offset| ties:
    the lower bucket is the nearest), and bucket logits with tied top
    probabilities (the lower bucket first)."""
    anc = np.concatenate([np.asarray(a) for a in JSB.square_anchors(SIZES)])
    rs = np.random.RandomState(12)
    sel = rs.choice(anc.shape[0], 40, replace=False)
    props = anc[sel]
    _, _, centres = JSB._bucket_edges(jnp.asarray(props))
    centres = np.asarray(centres)
    gt = props + rs.randn(40, 4).astype(np.float32) * 8
    mid = (centres[:, :, 2] + centres[:, :, 3]) / 2  # [N, 4] (l, r, t, d)
    gt[:10] = np.stack([mid[:10, 0], mid[:10, 2], mid[:10, 1],
                        mid[:10, 3]], 1)
    want = JSB.bbox2bucket(jnp.asarray(props), jnp.asarray(gt))
    got = TSB.bbox2bucket(t(props), t(gt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a = np.abs(np.asarray(want[0]))
    assert (np.sort(a, -1)[..., 0] == np.sort(a, -1)[..., 1]).any()
    logits = rs.randn(40, 4, TSB.SIDE_NUM).astype(np.float32)
    logits[:20, :, 1] = logits[:20, :, 4] = 5.0  # tied best two
    off = (0.3 * rs.randn(40, 4, TSB.SIDE_NUM)).astype(np.float32)
    wb, wc = JSB.bucket2bbox(jnp.asarray(props), jnp.asarray(logits),
                             jnp.asarray(off), max_shape=(120, 124))
    gb, gc = TSB.bucket2bbox(t(props), t(logits), t(off),
                             max_shape=(120, 124))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6)


@pytest.fixture(scope="module")
def coco_val(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_tree")
    _, val = write_coco_tree(str(root), images=1, val_images=2,
                             hw=(96, 128), seed=4)
    return dict(type="CocoDataset", ann_file=val, img_prefix=str(root) + "/")


@pytest.mark.parametrize("config", CONFIGS)
def test_test_cli(coco_val, config):
    torch.set_num_threads(2)
    res = tcli.main([f"{ROOT}/configs/det/{config}", "--tiny", "--device",
                     "cpu", "--cfg-options", f"data.test={coco_val!r}"])
    assert res["summary"]["frames"] == 2
    assert all(len(r) == 80 for r in res["dets"])
    assert all(np.isfinite(a).all() for r in res["dets"] for a in r)
    assert 0.0 <= res["metrics"]["mAP50"] <= 1.0
