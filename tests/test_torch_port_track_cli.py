"""The port's test CLI (``tools/test.py``) on the three tracking configs,
``--tiny --device cpu``, against the root JAX ``tools/test.py``, on PNG
trees whose frames fit the 64x64 bucket (scale factor 1, so ROADMAP fault
F15 does not enter) and on the JAX CLI's own weights (its zoo's seeded
initialisation, bridged into a port checkpoint):

- ``deepsort_faster-rcnn_fpn_4e_mot17-private-half.py`` on a MOT tree of
  ``write_mot_tree`` with its public ``detection_file``: equal CLEAR-MOT
  (``--eval track``) and equal MOT txt files (``--out``). The ReID net
  runs in bfloat16 on 256x128 crops on both sides, as the JAX CLI's
  ``--tiny`` leaves it; the tree keeps two objects far apart, so each
  track has one detection inside its gates and the association does not
  depend on the embeddings' rounding;
- ``tracktor_faster-rcnn_r50_fpn_4e_mot17-private-half.py`` with
  ``tracker.with_cmc=False`` (the JAX CLI never compensates camera motion,
  ROADMAP fault F16): equal metrics and the same rows (ids and frames
  exactly, boxes to the files' 2 decimals); with the config's
  ``with_cmc=True`` the port's route runs ECC on the raw frames;
- ``siamese_rpn_r50_1x_lasot.py`` on a LaSOT tree of
  ``write_lasot_tree``: equal OPE success, precision and normalized
  precision;
- a JPEG frame (MOT17's and LaSOT's format) is read; a corrupt one raises
  ``UnsupportedImage``, naming the file.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data.image_io import (
    UnsupportedImage,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_lasot_tree,
    write_mot_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import test as tcli
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEEPSORT = os.path.join(
    ROOT, "configs/mot/deepsort/deepsort_faster-rcnn_fpn_4e_mot17-private-"
    "half.py")
TRACKTOR = os.path.join(
    ROOT, "configs/mot/tracktor/tracktor_faster-rcnn_r50_fpn_4e_mot17-"
    "private-half.py")
SIAMRPN = os.path.join(ROOT, "configs/sot/siamese_rpn/"
                       "siamese_rpn_r50_1x_lasot.py")
# the JAX CLI's --tiny for MOT (tools/test.py run_mot_eval)
JAX_TINY_MOT = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=16,
                    compute_dtype=jnp.float32)


_pinned_threads = thread_count(1)


def jax_cli(argv):
    """The root ``tools/test.py``'s ``main`` in this process; its printed
    JSON summary."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "tools", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old, out = sys.argv, io.StringIO()
    sys.argv = ["test.py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _prefixed(variables, prefix):
    return {prefix + k: v for k, v in from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)).items()}


@pytest.fixture(scope="module")
def mot(tmp_path_factory):
    """A MOT tree and a port checkpoint of the JAX CLI's DeepSORT weights
    (its Tracktor's detector is the same: the same config and key)."""
    torch.set_num_threads(1)
    from lowlightenvironmentvideoobjectdetection_tpu import zoo  # noqa: F401
    from lowlightenvironmentvideoobjectdetection_tpu.registry import MODELS
    root = tmp_path_factory.mktemp("mot_cli")
    ann, dets = write_mot_tree(str(root), videos=1, frames=4, hw=(64, 64),
                               objects=2, seed=5, jitter=0.5)
    model = MODELS.get("DeepSORT")(num_classes=1, with_reid=True,
                                   **JAX_TINY_MOT)
    ckpt = str(root / "deepsort.pt")
    torch.save(dict(_prefixed(model.det_params, "detector."),
                    **_prefixed(model.reid_params, "reid.")), ckpt)
    opts = ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={root}/",
            f"data.test.detection_file={dets}"]
    return dict(root=root, ckpt=ckpt, opts=opts)


def read_mot_txt(out_dir):
    rows = {}
    for name in sorted(os.listdir(out_dir)):
        rows[name] = np.loadtxt(os.path.join(out_dir, name), delimiter=",",
                                ndmin=2)
    return rows


def _run_both(mot, cfg, tag, extra=()):
    jout = mot["root"] / f"jax_{tag}" / "r.json"
    tout = mot["root"] / f"port_{tag}" / "r.json"
    want = jax_cli([cfg, "--tiny", "--eval", "track", "--out", str(jout)]
                   + mot["opts"] + list(extra))
    got = tcli.main([cfg, "--tiny", "--device", "cpu", "--eval", "track",
                     "--checkpoint", mot["ckpt"], "--out", str(tout)]
                    + mot["opts"] + list(extra))
    return got, want, (read_mot_txt(tout.parent / "mot_results"),
                       read_mot_txt(jout.parent / "mot_results"))


def test_deepsort_cli_matches_the_jax_cli(mot):
    got, want, (trows, jrows) = _run_both(mot, DEEPSORT, "deepsort")
    assert got["summary"]["frames"] == want["frames"] == 4
    assert got["summary"]["track"] == want["track"]
    assert got["metrics"]["MOTA"] > 0.5
    assert trows.keys() == jrows.keys() and len(trows) == 1
    for k in trows:
        np.testing.assert_array_equal(trows[k], jrows[k])


def test_tracktor_cli_matches_the_jax_cli_without_cmc(mot):
    got, want, (trows, jrows) = _run_both(mot, TRACKTOR, "tracktor",
                                          ["tracker.with_cmc=False"])
    assert got["summary"]["track"] == want["track"]
    for k in jrows:
        t, j = trows[k], jrows[k]
        assert t.shape == j.shape
        np.testing.assert_array_equal(t[:, :2], j[:, :2])  # frame, id
        np.testing.assert_allclose(t[:, 2:7], j[:, 2:7], rtol=0,
                                   atol=0.0101)


def test_tracktor_cli_runs_ecc_with_the_configs_cmc(mot, monkeypatch):
    from lowlightenvironmentvideoobjectdetection_torch.core.motion import (
        cmc as TC,
    )
    calls = []
    estimate = TC.CameraMotionCompensation.estimate

    def counted(self, image, template):
        calls.append(1)
        return estimate(self, image, template)

    monkeypatch.setattr(TC.CameraMotionCompensation, "estimate", counted)
    out = tcli.main([TRACKTOR, "--tiny", "--device", "cpu", "--eval",
                     "track", "--checkpoint", mot["ckpt"]] + mot["opts"])
    assert out["summary"]["frames"] == 4 and "MOTA" in out["metrics"]
    assert calls  # frames 1-3 once tracks exist


def test_siamrpn_cli_matches_the_jax_cli(tmp_path):
    torch.set_num_threads(1)
    from lowlightenvironmentvideoobjectdetection_tpu.apis.inference import (
        SOTModel,
    )
    ann = write_lasot_tree(str(tmp_path), videos=2, frames=4, hw=(96, 128),
                           seed=6)
    ckpt = str(tmp_path / "siamrpn.pt")
    torch.save(from_jax_variables(jax.tree_util.tree_map(
        np.asarray, SOTModel(exemplar_size=64, search_size=128).params)),
        ckpt)
    opts = ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={tmp_path}/"]
    want = jax_cli([SIAMRPN, "--tiny"] + opts)
    got = tcli.main([SIAMRPN, "--tiny", "--device", "cpu", "--checkpoint",
                     ckpt] + opts)
    assert got["summary"]["frames"] == want["frames"] == 8
    assert got["summary"]["sot"] == want["sot"]
    assert all(np.isfinite(v) for v in got["metrics"].values())


def test_a_jpeg_frame_raises_with_the_jpeg_item(tmp_path):
    ann, dets = write_mot_tree(str(tmp_path), frames=2)
    with open(ann) as f:
        coco = json.load(f)
    png = coco["images"][0]["file_name"]
    name = png.replace(".png", ".jpg")
    coco["images"][0]["file_name"] = name
    with open(ann, "w") as f:
        json.dump(coco, f)
    frame = tcli.read_frame(dict(file_name=png), f"{tmp_path}/")
    assert cv2.imwrite(str(tmp_path / name), frame)
    np.testing.assert_array_equal(
        tcli.read_frame(dict(file_name=name), f"{tmp_path}/"),
        cv2.imread(str(tmp_path / name), cv2.IMREAD_COLOR))
    with open(tmp_path / name, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(UnsupportedImage, match=f"{name}: corrupt JPEG"):
        tcli.main([DEEPSORT, "--tiny", "--device", "cpu", "--cfg-options",
                   f"data.test.ann_file={ann}",
                   f"data.test.img_prefix={tmp_path}/",
                   f"data.test.detection_file={dets}"])
