"""The port and ``chip_smoke.py`` need none of ``jax``, ``cv2``, ``PIL``
and the JAX package: the machine with the card has none of them. No source
file of the port or ``chip_smoke.py`` names one of them in an import
statement, guarded or not (a ``try: import cv2`` would pass in the blocked
interpreter below and read frames otherwise here than on the card). In a
fresh interpreter with those names blocked in ``sys.modules`` (an import of
a blocked name raises), every module of the port and ``chip_smoke`` import,
a JPEG fixture decodes, and the canonical config's data path runs: a tree
of PNG pairs is written and read back, a training batch is built from it,
and the test CLI evaluates the config on it; the FGFA config streams two
frames; the test CLI's MOT route tracks a tiny MOT tree of PNG frames with
DeepSORT (the JV solver built from ``csrc/lap.cpp``, ECC-free) and
CLEAR-MOT; the image route detects a noise image with FPN Faster R-CNN
and evaluates the VOC config on a VOC tree of JPEG images and XML."""

import ast
import os
import pkgutil
import subprocess
import sys

from torch_port_threads import thread_count

import lowlightenvironmentvideoobjectdetection_torch as port

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
           "lowlightenvironmentvideoobjectdetection_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))


_pinned_threads = thread_count(1)


def test_port_runs_without_jax_cv2_or_pil(tmp_path):
    mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + ".")]
    assert {port.__name__ + m for m in (
        ".data.image_io", ".tools.train", ".data.loader", ".tools.test",
        ".apis.test", ".core.eval.mean_ap", ".models.backbones.dark_resnet",
        ".models.cleaners.video_denoisers",
        ".models.vid.selsa_fastdvd", ".ops.grid_sample",
        ".models.motion.flownet_simple", ".models.detectors.faster_rcnn",
        ".models.vid.fgfa", ".core.motion.kalman", ".core.motion.linear",
        ".core.motion.cmc", ".core.track_utils", ".core.eval.mot",
        ".core.eval.sot", ".ops.lap", ".ops.scale_translate",
        ".models.mot.trackers", ".models.mot.deep_sort",
        ".models.reid.base_reid", ".models.sot.siamrpn",
        ".data.mot_sot_datasets", ".data.jpeg", ".utils.host_build",
        ".utils.torch_import", ".tools.learning_smoke", ".apis.families",
        ".models.necks.fpn", ".models.detectors.fpn_faster_rcnn",
        ".models.dense_heads.retina_head", ".models.detectors.more_rcnn",
        ".data.coco_det", ".data.sot_pairs",
        ".tools.mot_param_search", ".models.necks.extra_necks",
        ".models.dense_heads.guided_anchor_head", ".data.voc",
        ".models.roi_heads.mask_head", ".models.detectors.mask_rcnn",
        ".ops.point_sample", ".models.detectors.htc",
        ".models.dense_heads.yolact_head", ".core.eval.instseg")} <= set(mods)
    code = f"""
import importlib, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # 'import name' raises ImportError
for m in {mods!r} + ["chip_smoke"]:
    importlib.import_module(m)
from {port.__name__}.data.image_io import imread
assert imread("tests/data/jpeg/progressive_420.jpg").shape == (48, 64, 3)
from {port.__name__}.config import Config, apply_cli_options
from {port.__name__}.data.loader import TrainLoader
from {port.__name__}.data.synthetic import write_darkfarm_tree
ann = write_darkfarm_tree({str(tmp_path)!r}, videos=1, frames=4,
                          hw=(40, 64))
cfg = Config.fromfile("configs/vid/llvod/"
                      "llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")
apply_cli_options(cfg, ["data.train.ann_file=" + ann,
                        "data.train.img_prefix={tmp_path}/"])
batch = next(TrainLoader(cfg, 64, 96, 3, device="cpu", workers=0))
assert tuple(batch.pair_imgs.shape) == (1, 3, 64, 96, 6)
assert bool(batch.gt_valid.any())
from {port.__name__}.tools import test
out = test.main(["configs/vid/llvod/"
                 "llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py",
                 "--tiny", "--device", "cpu", "--cfg-options",
                 "data.test.ann_file=" + ann,
                 "data.test.img_prefix={tmp_path}/",
                 "model.neck_channels=32", "data.workers_per_gpu=0"])
assert out["summary"]["frames"] == 4 and "mAP50" in out["summary"]
out = test.main(["configs/vid/fgfa/fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py",
                 "--tiny", "--device", "cpu", "--synthetic", "2",
                 "--cfg-options", "model.neck_channels=32",
                 "model.num_ref_frames=2"])
assert out["summary"]["frames"] == 2
from {port.__name__}.data.synthetic import write_mot_tree
mann, mdets = write_mot_tree({str(tmp_path / "mot")!r}, frames=3)
out = test.main(["configs/mot/deepsort/"
                 "deepsort_faster-rcnn_fpn_4e_mot17-private-half.py",
                 "--tiny", "--device", "cpu", "--eval", "track",
                 "--cfg-options", "data.test.ann_file=" + mann,
                 "data.test.img_prefix={tmp_path / "mot"}/",
                 "data.test.detection_file=" + mdets])
assert out["summary"]["frames"] == 3 and "MOTA" in out["summary"]["track"]
out = test.main(["configs/det/faster_rcnn_r50_fpn_1x_coco.py", "--tiny",
                 "--device", "cpu", "--synthetic", "1"])
assert out["summary"]["model"] == "FasterRCNNFPN"
from {port.__name__}.data.synthetic import write_voc_tree
vann, vprefix = write_voc_tree({str(tmp_path / "voc")!r}, images=2)
out = test.main(["configs/det/faster_rcnn_r50_dc5_1x_voc.py", "--tiny",
                 "--device", "cpu", "--cfg-options",
                 "data.test.ann_file=" + vann,
                 "data.test.img_prefix=" + vprefix,
                 "model.neck_channels=32"])
assert out["summary"]["frames"] == 2 and "mAP50" in out["summary"]
loaded = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=180)


def test_no_source_file_imports_jax_cv2_or_pil():
    files = [os.path.join(d, f) for d, _, fs in os.walk(port.__path__[0])
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, node.lineno, n) for n in names
                      if n.split(".")[0] in BLOCKED]
    assert len(files) > 90 and not found, found
