"""Train a config of the repository with the port, the counterpart of the
JAX package's ``tools/train.py``:

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.train \\
        configs/vid/llvod/llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py \\
        --steps N [--work-dir DIR] [--tiny] [--synthetic] [--seed S] \\
        [--resume-from DIR/step_K.pt] [--cfg-options key=value ...] \\
        [--device cuda|cpu]

Reads the config (``_base_`` files and ``--cfg-options`` applied), builds
its model (``models/builder.py``) with weights seeded by ``--seed`` on the
card (``--device cpu`` for the CPU; without a card and without
``--device`` it raises), and trains it through ``apis.train.train_model``
on batches of its ``data.train`` (``data/loader.py``: COCO-VID annotations
and PNG or JPEG frames, ``data.workers_per_gpu`` loader processes) or, with
``--synthetic``, on uniform noise as the JAX CLI's synthetic batches
(``DarkfarmBatch``es of (noise, clean) pairs; ``FastDVDBatch``es of the
same pairs for ``SelsaFastDVDnetDetect``; ``TrainBatch``es of plain
frames for the ImageNet-VID families SELSA, FGFA and DFF, which train on
the pipeline's key and references, their first 3 channels).
``--tiny`` shrinks the bucket and the proposal counts as the JAX CLI's
``TINY_KW`` and computes in float32. Appends a line to
``WORK_DIR/train_log.json`` and saves ``WORK_DIR/step_<N>.pt`` with
``torch.save``; ``--resume-from`` continues from such a file (its
parameters, momentum, step and the data order). With ``evaluation.interval``
in the config and a ``data.val`` (else ``data.test``) whose ``ann_file``
exists, every ``interval`` steps the current detector streams that split
(``make_eval_fn``) and its ``mAP50`` is logged as ``eval: mAP50=...``.

The image detectors (a type of ``apis/families.py``: FasterRCNN, FastRCNN,
RPN, FasterRCNNFPN and its GA-RPN, GRoIE and Libra variants, RetinaNet,
GARetinaNet, and the dense heads FCOS, NASFCOS, ATSS, GFL, PAA, VFNet,
FreeAnchor and PISA (RetinaNet); the JAX package's other families raise
``NotImplementedError``) train through their family's loss, as the JAX
CLI's family route: on ``--synthetic`` batches (``families.
make_synth_batch``) or on a ``CocoDataset`` ``data.train`` (one image a
``DetTrainBatch``, padded to the family's bucket, ``families.pad_hw``),
which a user passes with ``--cfg-options`` (the configs have none); any
other ``data.train`` type (a ``VOCDataset``, say) raises, as the JAX CLI
feeds image detectors from a ``CocoDataset`` only. Their runs take no eval
hook.

SiamRPN++ (``model.type=SiamRPN``) trains on template and search pairs of
a ``SOTTrainDataset`` ``data.train`` (``data/sot_pairs.py``: mmtrack's
SOT augmentations), with ``siamrpn_loss``, SiamRPN++'s schedule
(``make_sot_lr_schedule`` from the config's ``optimizer.lr``, 0.005 by
default) and its backbone frozen until ``unfreeze_epoch`` (10; an epoch is
1000 steps), the stem and stage 1 throughout (``sot_trainable``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..apis import families as FAM
from ..apis.inference import VIDModel, detector_state
from ..apis.test import evaluate_bbox, single_device_test
from ..apis.train import train_model
from ..config import Config, apply_cli_options
from ..data.loader import TrainLoader, build_dataset, loader_workers
from ..data.mot_sot_datasets import SOTTrainDataset
from ..data.pipelines import Compose
from ..data.sot_pairs import sot_batches
from ..models.builder import (SOT_TYPES, build_model, sot_model_kwargs,
                              vid_model_kwargs)
from ..models.sot import siamrpn as SR
from ..models.vid.selsa import TrainBatch, init_params
from ..models.vid.selsa_darkfarm import DarkfarmBatch
from ..models.vid.selsa_fastdvd import FastDVDBatch, FastDVDSelsaConfig
from ..parallel.train import (Optimizer, make_sot_lr_schedule,
                              sot_trainable)
from ..utils.checkpoint import checkpoint_step, save_checkpoint
from ..utils.device import full_f32_precision, resolve_device


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a video detector")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="steps to train (default: the config's epochs x "
                        "1000)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on random batches (no data needed)")
    p.add_argument("--tiny", action="store_true",
                   help="shrink shapes for smoke runs, float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def synthetic_batches(system, device, seed: int):
    """The JAX CLI's synthetic batches: frames U(-2, 2) [3, pad_h, pad_w,
    2C] (3 channels for the ImageNet-VID families, as ``TrainBatch``es),
    2 valid gts of 4, one sample a batch."""
    rng = np.random.RandomState(seed)
    s = system.detector_cfg
    channels = 2 * system.cfg.in_channels if system.pairs else 3
    batch = DarkfarmBatch if system.pairs else TrainBatch
    while True:
        imgs = rng.uniform(-2, 2, (3, s.pad_h, s.pad_w, channels))
        fields = (imgs.astype(np.float32),
                  np.asarray([s.pad_h, s.pad_w], np.float32),
                  np.asarray([[8.0, 8.0, 40.0, 40.0]] * 4, np.float32),
                  np.asarray([1] * 4, np.int64),
                  np.asarray([True, True, False, False]))
        yield batch(*(torch.as_tensor(a, device=device)[None]
                      for a in fields))


def image_synthetic_batches(model, fam, device, seed: int):
    """The JAX CLI's synthetic batches of an image family
    (``families.make_synth_batch``), with a leading batch axis of 1."""
    rng = np.random.RandomState(seed)
    while True:
        b = FAM.make_synth_batch(model, fam, rng, device)
        yield type(b)(*(t[None] for t in b))


class ImageSystem:
    """An image family's model and its loss, in the shape of
    ``models/builder.py``'s ``System`` that the CLI trains."""

    def __init__(self, model_cfg: dict, tiny: bool, seed: int, device):
        kw = dict(model_cfg)
        self.family = FAM.get_family(kw.pop("type"))
        self.model, self.aux = self.family.build(kw, tiny, seed, device)
        self.pad_hw = FAM.pad_hw(self.model, self.family, tiny)

    def loss_fn(self, model, sample, generator):
        return self.family.loss(model, self.aux, sample, generator)


class SOTSystem:
    """SiamRPN++ with seeded weights, its anchors and ``siamrpn_loss``."""

    iters_per_epoch = 1000
    unfreeze_epoch = 10

    def __init__(self, model_cfg: dict, tiny: bool, seed: int, device):
        self.cfg = SR.SiamRPNConfig(**sot_model_kwargs(model_cfg, tiny))
        self.model = SR.SiamRPN(self.cfg)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(device)
        n = self.cfg.score_size
        self.anchors = torch.as_tensor(SR.sot_grid_anchors(self.cfg, n),
                                       device=device)

    def loss_fn(self, model, sample, generator):
        u = torch.rand((2, self.anchors.shape[0]), generator=generator,
                       device=generator.device).to(self.anchors.device)
        return SR.siamrpn_loss(model, sample.z_img[None], sample.x_img[None],
                               sample.gt_cxcywh, self.anchors,
                               sample.is_positive, u)

    def optimizer(self, base_lr: float, start: int = 0) -> Optimizer:
        """SGD with SiamRPN++'s schedule and the mask of step ``start``'s
        epoch."""
        names = [n for n, _ in self.model.named_parameters()]
        return Optimizer(
            sot_trainable(names, start // self.iters_per_epoch,
                          self.unfreeze_epoch),
            make_sot_lr_schedule(base_lr,
                                 iters_per_epoch=self.iters_per_epoch))

    def on_step(self, optimizer: Optimizer, step: int) -> None:
        """The mask of the epoch that step ``step`` (1-based) ends."""
        names = list(optimizer.trainable)
        optimizer.trainable = sot_trainable(
            names, step // self.iters_per_epoch, self.unfreeze_epoch)


def make_eval_fn(cfg, vcfg: dict, model: torch.nn.Module, tiny: bool,
                 device) -> Callable:
    """The EvalHook of the JAX CLI (``tools/train.py:305-362``): builds the
    streaming ``VIDModel`` of the config (``vid_model_kwargs``), the split
    ``vcfg``'s test dataset and pipeline once; each call copies the
    training ``state``'s current detector weights into the ``VIDModel``
    (``detector_state``: the ``selsa.`` entries of a darkfarm model, whose
    cleaner and aggregator play no part in streaming; the whole tree of
    the ImageNet-VID families) in its own storage and dtypes,
    streams the split (``single_device_test``) and returns
    ``evaluate_bbox``'s ``{"mAP50": ...}``. Nothing of the trainer is
    written: its parameters, optimizer state, generators and modes stay as
    they are."""
    with torch.random.fork_rng(devices=[]):  # the build draws its init
        vid = VIDModel(state_dict=model.state_dict(), device=device,
                       **vid_model_kwargs(cfg["model"],
                                          vcfg.get("ref_img_sampler"), tiny))
    ds = build_dataset(vcfg, test_mode=True)
    pipe = Compose(vcfg["pipeline"], device=device)
    workers = loader_workers(cfg)

    def eval_fn(state):
        # load_state_dict copies into the VIDModel's own tensors (cast to
        # their dtypes), so the trainer's parameters are only read
        vid.model.load_state_dict(detector_state(state.model.state_dict()),
                                  strict=True)
        det_lists, annotations = single_device_test(vid, ds, pipe,
                                                    workers=workers)
        return evaluate_bbox(det_lists, annotations)

    return eval_fn


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable] = None) -> dict:
    """Run the CLI on ``argv``; ``on_step(state, metrics)`` is called after
    each step. Returns the final ``state``, the ``log`` line, each step's
    ``metrics``, the loader's ``timings`` (None with ``--synthetic``) and
    each periodic evaluation's results (``evals``)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    apply_cli_options(cfg, args.cfg_options)
    device = resolve_device(args.device)
    full_f32_precision()
    sot = cfg["model"]["type"] in SOT_TYPES
    image = not sot and FAM.get_family(cfg["model"]["type"]) is not None
    if sot:
        system = SOTSystem(cfg["model"], args.tiny, args.seed, device)
    elif image:
        system = ImageSystem(cfg["model"], args.tiny, args.seed, device)
    else:
        system = build_model(cfg["model"], tiny=args.tiny, seed=args.seed,
                             device=device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs")
    os.makedirs(work_dir, exist_ok=True)
    steps = args.steps or cfg.get("total_epochs", 7) * 1000
    opt_cfg = cfg.get("optimizer", {})
    start = checkpoint_step(args.resume_from) if args.resume_from else 0
    loader, optimizer = None, None
    if sot:
        d = cfg["data"]["train"]
        data = sot_batches(SOTTrainDataset(
            ann_file=d["ann_file"], img_prefix=d.get("img_prefix", "")),
            args.seed, device, start, system.cfg.exemplar_size,
            system.cfg.search_size)
        optimizer = system.optimizer(opt_cfg.get("lr", 0.005), start)
    elif image and args.synthetic:
        data = image_synthetic_batches(system.model, system.family, device,
                                       args.seed)
    elif image:
        dtype = cfg["data"]["train"]["type"]
        if dtype != "CocoDataset":
            raise ValueError(
                f"data.train type {dtype!r}: the image route trains on a "
                f"CocoDataset only, as the JAX package's tools/train.py "
                f"feeds image detectors (VOC training is not a feature "
                f"of either)")
        loader = data = TrainLoader(cfg, *system.pad_hw, 3, seed=args.seed,
                                    start=start, device=device, pairs=False)
    elif args.synthetic:
        data = synthetic_batches(system, device, args.seed)
    else:
        s = system.detector_cfg
        loader = data = TrainLoader(
            cfg, s.pad_h, s.pad_w, getattr(system.cfg, "in_channels", 3),
            seed=args.seed, start=start, device=device, pairs=system.pairs)
    if not (image or sot) and isinstance(system.cfg, FastDVDSelsaConfig):
        data = (FastDVDBatch(*b) for b in data)  # the same pairs
    metrics, evals = [], []
    eval_fn, eval_interval = None, 0
    vcfg = (cfg.get("data") or {}).get("val") or (cfg.get("data") or {}).get(
        "test")
    interval = (cfg.get("evaluation") or {}).get("interval")
    if (interval and vcfg and os.path.exists(vcfg.get("ann_file", ""))
            and not (image or sot)):
        hook = make_eval_fn(cfg, vcfg, system.model, args.tiny, device)
        eval_interval = int(interval)

        def eval_fn(state):
            evals.append(hook(state))
            return evals[-1]

    def step_done(state, m):
        if sot:
            system.on_step(optimizer, state.step)
        metrics.append(m)
        if on_step is not None:
            on_step(state, m)

    t0 = time.perf_counter()
    try:
        state = train_model(
            system.loss_fn, system.model, data, steps,
            base_lr=opt_cfg.get("lr", 0.01), seed=args.seed,
            checkpoint_dir=work_dir,
            log_interval=cfg.get("log_config", {}).get("interval", 50),
            resume_from=args.resume_from, on_step=step_done,
            eval_fn=eval_fn, eval_interval=eval_interval,
            optimizer=optimizer)
    finally:
        if loader is not None:
            loader.close()
    log = dict(config=args.config, steps=int(state.step),
               wall_s=round(time.perf_counter() - t0, 2))
    with open(os.path.join(work_dir, "train_log.json"), "a") as f:
        f.write(json.dumps(log) + "\n")
    print(json.dumps(log))
    path = save_checkpoint(work_dir, state)
    print(f"saved final checkpoint to {path}")
    return dict(state=state, log=log, metrics=metrics,
                timings=loader.timings if loader is not None else None,
                evals=evals)


if __name__ == "__main__":
    main()
