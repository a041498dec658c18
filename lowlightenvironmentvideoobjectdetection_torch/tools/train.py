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
and PNG frames, ``data.workers_per_gpu`` loader processes) or, with
``--synthetic``, on uniform noise as the JAX CLI's synthetic batches.
``--tiny`` shrinks the bucket and the proposal counts as the JAX CLI's
``TINY_KW`` and computes in float32. Appends a line to
``WORK_DIR/train_log.json`` and saves ``WORK_DIR/step_<N>.pt`` with
``torch.save``; ``--resume-from`` continues from such a file (its
parameters, momentum, step and the data order). The periodic evaluation
hook of the JAX CLI is not ported yet (ROADMAP.md Queue 1, evaluation).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..apis.train import train_model
from ..config import Config, apply_cli_options
from ..data.loader import TrainLoader
from ..models.builder import build_model
from ..models.vid.selsa_darkfarm import DarkfarmBatch
from ..utils.checkpoint import checkpoint_step, save_checkpoint
from ..utils.device import resolve_device


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


def synthetic_batches(cfg, device, seed: int):
    """The JAX CLI's synthetic batches: frames U(-2, 2) [3, pad_h, pad_w,
    2C], 2 valid gts of 4, one sample a batch."""
    rng = np.random.RandomState(seed)
    s = cfg.selsa
    while True:
        imgs = rng.uniform(-2, 2, (3, s.pad_h, s.pad_w, 2 * cfg.in_channels))
        fields = (imgs.astype(np.float32),
                  np.asarray([s.pad_h, s.pad_w], np.float32),
                  np.asarray([[8.0, 8.0, 40.0, 40.0]] * 4, np.float32),
                  np.asarray([1] * 4, np.int64),
                  np.asarray([True, True, False, False]))
        yield DarkfarmBatch(*(torch.as_tensor(a, device=device)[None]
                              for a in fields))


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable] = None) -> dict:
    """Run the CLI on ``argv``; ``on_step(state, metrics)`` is called after
    each step. Returns the final ``state``, the ``log`` line, each step's
    ``metrics`` and the loader's ``timings`` (None with
    ``--synthetic``)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    apply_cli_options(cfg, args.cfg_options)
    device = resolve_device(args.device)
    system = build_model(cfg["model"], tiny=args.tiny, seed=args.seed,
                         device=device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs")
    os.makedirs(work_dir, exist_ok=True)
    steps = args.steps or cfg.get("total_epochs", 7) * 1000
    opt_cfg = cfg.get("optimizer", {})
    start = checkpoint_step(args.resume_from) if args.resume_from else 0
    loader = None
    if args.synthetic:
        data = synthetic_batches(system.cfg, device, args.seed)
    else:
        s = system.cfg.selsa
        loader = data = TrainLoader(cfg, s.pad_h, s.pad_w,
                                    system.cfg.in_channels, seed=args.seed,
                                    start=start, device=device)
    metrics = []

    def step_done(state, m):
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
            resume_from=args.resume_from, on_step=step_done)
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
                timings=loader.timings if loader is not None else None)


if __name__ == "__main__":
    main()
