"""Training API, the counterpart of the JAX package's ``apis/train.py``
(``TrainLoop``, ``train_model``): a host loop over ``Trainer.step`` with
logging and checkpoints, on one card.

Each step's per-sample generators derive from (seed, global step, sample),
as the JAX loop folds the global step into its key, so a run resumed from a
checkpoint replays the samples of the run it continues.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..parallel.train import (Trainer, TrainState, make_lr_schedule,
                              make_optimizer)
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import full_f32_precision


def step_generators(seed: int, step: int, batch_size: int
                    ) -> List[torch.Generator]:
    """One CPU generator per sample of global step ``step``."""
    return [torch.Generator().manual_seed(int(
        np.random.SeedSequence((seed, step, i)).generate_state(1, np.uint64)[0]))
        for i in range(batch_size)]


@dataclasses.dataclass
class TrainLoop:
    """Host loop over the train step: logging every ``log_interval``
    steps, a checkpoint every ``checkpoint_interval`` steps when
    ``checkpoint_dir`` is set, ``on_step(state, metrics)`` after each step
    when given, and every ``eval_interval`` steps, when ``eval_fn`` is
    given, ``eval_fn(state)`` -> {name: value}, logged as ``eval: k=v
    ...`` (mmcv's EvalHook). ``eval_fn`` reads the state; the training
    does not depend on it."""

    trainer: Trainer
    log_interval: int = 50
    checkpoint_interval: int = 1000
    checkpoint_dir: Optional[str] = None
    on_step: Optional[Callable[[TrainState, dict], None]] = None
    eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None
    eval_interval: int = 0

    def run(self, state: TrainState, data_iter: Iterable, num_steps: int,
            seed: int, log_fn: Callable[[str], None] = print) -> TrainState:
        t0 = time.perf_counter()
        start = state.step
        for i, batch in enumerate(data_iter):
            if i >= num_steps:
                break
            rngs = step_generators(seed, start + i, batch[0].shape[0])
            state, metrics = self.trainer.step(state, batch, rngs)
            if self.on_step is not None:
                self.on_step(state, metrics)
            if (i + 1) % self.log_interval == 0:
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                log_fn(f"step {i + 1}/{num_steps} "
                       + " ".join(f"{k}={v:.4f}"
                                  for k, v in sorted(metrics.items()))
                       + f" ({self.log_interval / dt:.2f} it/s)")
            if self.checkpoint_dir and (i + 1) % self.checkpoint_interval == 0:
                save_checkpoint(self.checkpoint_dir, state)
            if (self.eval_fn and self.eval_interval
                    and (i + 1) % self.eval_interval == 0):
                res = self.eval_fn(state)
                log_fn("eval: " + " ".join(f"{k}={v:.4f}"
                                           for k, v in res.items()))
        return state


def train_model(loss_fn: Callable, model: nn.Module, data_iter: Iterable,
                num_steps: int, base_lr: float = 0.01,
                iters_per_epoch: int = 1000, seed: int = 0,
                resume_from: Optional[str] = None, optimizer=None,
                **loop_kwargs) -> TrainState:
    """One-call training: the JAX ``make_optimizer`` with the mmcv step
    schedule, a ``Trainer`` over ``loss_fn(model, sample, generator)`` and a
    ``TrainLoop``. ``resume_from`` restores a whole ``TrainState``
    checkpoint (parameters, momentum, step) into ``model``, so the schedule
    and the samples continue where they left off. ``optimizer`` replaces
    the default one (SiamRPN++'s schedule and mask). ``loop_kwargs`` go to
    ``TrainLoop`` (``eval_fn`` and ``eval_interval`` among them). Returns
    the final state. TF32 is turned off (``full_f32_precision``)."""
    full_f32_precision()
    opt = optimizer or make_optimizer(model, lr=make_lr_schedule(
        base_lr, iters_per_epoch=iters_per_epoch))
    trainer = Trainer(loss_fn=loss_fn, optimizer=opt)
    state = trainer.init_state(model)
    if resume_from:
        state = load_checkpoint(resume_from, state)
    loop = TrainLoop(trainer=trainer, **loop_kwargs)
    return loop.run(state, data_iter, num_steps, seed)
