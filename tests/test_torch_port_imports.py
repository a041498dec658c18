"""The port and ``chip_smoke.py`` need none of ``jax``, ``cv2``, ``PIL``
and the JAX package: the machine with the card has none of them. In a
fresh interpreter with those names blocked in ``sys.modules`` (an import
of a blocked name raises), every module of the port and ``chip_smoke``
import, and the canonical config's data path runs: a tree of PNG pairs is
written and read back, and a training batch is built from it."""

import os
import pkgutil
import subprocess
import sys

import lowlightenvironmentvideoobjectdetection_torch as port

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
           "lowlightenvironmentvideoobjectdetection_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))


def test_port_runs_without_jax_cv2_or_pil(tmp_path):
    mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + ".")]
    assert {port.__name__ + ".data.image_io", port.__name__ + ".tools.train",
            port.__name__ + ".data.loader"} <= set(mods)
    code = f"""
import importlib, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # 'import name' raises ImportError
for m in {mods!r} + ["chip_smoke"]:
    importlib.import_module(m)
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
loaded = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=180)
