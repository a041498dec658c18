"""Training on one card: the counterpart of the JAX package's
``parallel/train.py`` (``frozen_mask``, ``make_lr_schedule``,
``make_optimizer``, ``TrainState``, ``Trainer``) without the mesh.

The optimizer is optax's chain ``clip_by_global_norm(35)``, masked
``add_decayed_weights(1e-4)``, ``sgd(lr, momentum=0.9)`` and a masked
``set_to_zero`` on the frozen leaves, written out elementwise in the same
order, so each update is optax's to the rounding of the global norm (its
sum runs over the leaves in another order):

- the global norm covers every gradient; where it is at least the maximum,
  each gradient becomes ``g / norm * max_norm`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- trainable leaves take ``g + weight_decay * p``; the momentum trace is
  ``t = g + momentum * t`` and the update ``-lr(count) * t``, ``count``
  starting at 0;
- frozen leaves (the stem and stage 1, by name prefix) take no decay, no
  trace and no update, so they stay bit-identical. A trainable leaf with no
  gradient counts as a zero gradient, as in JAX.

``make_sot_lr_schedule`` and ``unfreeze_mask_at_epoch`` are SiamRPN++'s
schedule and backbone unfreezing (the JAX package's functions of those
names); ``sot_trainable`` combines the latter with ``frozen_mask`` into an
``Optimizer``'s mask. A leaf that turns trainable starts with a zero
momentum trace.

``Adam`` is optax's ``chain(clip_by_global_norm(10), adam(lr))``, the
optimizer of the learning smoke, with the same interface and mask: the
same clip rule; ``mu = (1 - b1) * g + b1 * mu`` and
``nu = (1 - b2) * g ** 2 + b2 * nu``; bias corrections ``1 - b ** count``
in float32, ``count`` counting this update; the update
``-lr * (mu / c1) / (sqrt(nu / c2) + eps)``, eps outside the root. It
runs each of these as one multi-tensor op over the trainable leaves
(``torch._foreach_*``), elementwise as optax.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

FROZEN_PREFIXES = ("backbone/conv1", "backbone/bn1", "backbone/layer1",
                   "cleaner")
# the reference schedule: linear warmup over 500 iterations from a third of
# the rate, then a tenth at epochs 2 and 5
WARMUP_ITERS, WARMUP_RATIO, STEP_EPOCHS, GAMMA = 500, 1.0 / 3.0, (2, 5), 0.1


def frozen_mask(names: Sequence[str]) -> Dict[str, bool]:
    """name -> True for a trainable leaf. A leaf is frozen when one of
    FROZEN_PREFIXES matches its '/'-joined path at a segment boundary, at
    any depth, as in the JAX package ('backbone/layer1' catches
    'backbone/layer1_0/...')."""
    def trainable(name):
        path = "/" + name.replace(".", "/")
        return not any(f"/{f}" in path for f in FROZEN_PREFIXES)

    return {n: trainable(n) for n in names}


def make_lr_schedule(base_lr: float = 0.01, iters_per_epoch: int = 1000
                     ) -> Callable[[int], np.float32]:
    """mmcv's 'step' policy with linear warmup, in float32 in the JAX
    schedule's order of operations."""
    f32 = np.float32

    def sched(count: int) -> np.float32:
        frac = f32(1 - WARMUP_RATIO) * f32(min(count, WARMUP_ITERS)) \
            / f32(WARMUP_ITERS)
        warm = f32(base_lr) * (f32(WARMUP_RATIO) + frac)
        epoch = count // iters_per_epoch
        decay = f32(1.0)
        for e in STEP_EPOCHS:
            decay = decay * (f32(GAMMA) if epoch >= e else f32(1.0))
        return f32(warm * decay)

    return sched


def make_sot_lr_schedule(base_lr: float = 0.005, warmup_epochs: int = 5,
                         total_epochs: int = 20, iters_per_epoch: int = 1000,
                         start_factor: float = 0.2,
                         end_lr_factor: float = 0.1
                         ) -> Callable[[int], np.float32]:
    """SiamRPN++'s schedule (mmtrack's ``sot_lr_updater.py``): linear
    warm-up from ``start_factor`` of the rate over the first epochs, then
    a log-space decay to ``end_lr_factor`` of it, in float32 in the JAX
    schedule's order of operations."""
    f32 = np.float32
    warm_iters = warmup_epochs * iters_per_epoch
    total_iters = total_epochs * iters_per_epoch

    def sched(count: int) -> np.float32:
        frac = np.clip(f32(count) / f32(max(warm_iters, 1)), f32(0), f32(1))
        warm = f32(base_lr) * (f32(start_factor)
                               + f32(1 - start_factor) * frac)
        decay_frac = np.clip(f32(count - warm_iters)
                             / f32(max(total_iters - warm_iters, 1)),
                             f32(0), f32(1))
        decay = f32(base_lr) * np.exp(np.log(f32(end_lr_factor))
                                      * decay_frac)
        return f32(warm if count < warm_iters else decay)

    return sched


def unfreeze_mask_at_epoch(names: Sequence[str], epoch: int,
                           unfreeze_epoch: int = 10,
                           backbone_prefix: str = "backbone"
                           ) -> Dict[str, bool]:
    """name -> trainable under SiamRPN++'s backbone unfreezing (mmtrack's
    ``sot_optimizer_hook.py``): the backbone's leaves (``backbone_prefix``
    a segment of the path) from ``unfreeze_epoch`` on, every other leaf
    always."""
    unfrozen = epoch >= unfreeze_epoch

    def trainable(name):
        in_backbone = f"/{backbone_prefix}/" in "/" + name.replace(".", "/") \
            + "/"
        return (not in_backbone) or unfrozen

    return {n: trainable(n) for n in names}


def sot_trainable(names: Sequence[str], epoch: int,
                  unfreeze_epoch: int = 10) -> Dict[str, bool]:
    """The SiamRPN++ mask at ``epoch``: ``unfreeze_mask_at_epoch`` and
    ``frozen_mask`` (the stem and stage 1 stay frozen throughout)."""
    um = unfreeze_mask_at_epoch(names, epoch, unfreeze_epoch)
    fm = frozen_mask(names)
    return {n: um[n] and fm[n] for n in names}


class OptState(NamedTuple):
    count: int  # updates applied so far
    trace: Dict[str, torch.Tensor]  # momentum per trainable leaf


@dataclasses.dataclass
class Optimizer:
    """SGD with momentum, masked weight decay and global-norm clipping; see
    the module docstring. ``trainable`` is ``frozen_mask``'s result, ``lr``
    maps the update count to the rate."""

    trainable: Dict[str, bool]
    lr: Callable[[int], float]
    momentum = 0.9
    weight_decay = 1e-4
    grad_clip_norm = 35.0

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {n: torch.zeros_like(p) for n, p in params.items()
                            if self.trainable[n]})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], state: OptState
             ) -> Tuple[OptState, float]:
        """Apply one update to ``params`` in place from their ``.grad``.
        Returns the new state and the gradients' global norm."""
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
        clip = bool(norm >= self.grad_clip_norm)
        step_size = -float(self.lr(state.count))  # applied in float32
        trace = {}
        for n, p in params.items():
            if not self.trainable[n]:
                continue
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(p)
            elif clip:
                g = g / norm * self.grad_clip_norm
            g = g + self.weight_decay * p
            prev = state.trace.get(n)  # None: the leaf was frozen so far
            t = g if prev is None else g + self.momentum * prev
            trace[n] = t
            p.add_(t * step_size)
        return OptState(state.count + 1, trace), float(norm)


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: Dict[str, torch.Tensor]  # first moment per trainable leaf
    nu: Dict[str, torch.Tensor]  # second moment per trainable leaf


@dataclasses.dataclass
class Adam:
    """Adam after a global-norm clip, with optax's semantics; see the
    module docstring. ``trainable`` and ``lr`` as in ``Optimizer``."""

    trainable: Dict[str, bool]
    lr: Callable[[int], float]
    b1 = 0.9
    b2 = 0.999
    eps = 1e-8
    grad_clip_norm = 10.0

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = {n: torch.zeros_like(p) for n, p in params.items()
                 if self.trainable[n]}
        return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], state: AdamState
             ) -> Tuple[AdamState, float]:
        """Apply one update to ``params`` in place from their ``.grad``.
        Returns the new state and the gradients' global norm."""
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
        names = [n for n in params if self.trainable[n]]
        g = [grads[n] if n in grads else torch.zeros_like(params[n])
             for n in names]
        if bool(norm >= self.grad_clip_norm):
            g = torch._foreach_mul(torch._foreach_div(g, norm),
                                   self.grad_clip_norm)
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** count)
        c2 = float(f32(1) - f32(self.b2) ** count)
        mu = torch._foreach_add(
            torch._foreach_mul(g, 1 - self.b1),
            torch._foreach_mul([state.mu[n] for n in names], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul([state.nu[n] for n in names], self.b2))
        den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, c1), den)
        torch._foreach_mul_(update, -float(self.lr(state.count)))
        torch._foreach_add_([params[n] for n in names], update)
        return (AdamState(count, dict(zip(names, mu)), dict(zip(names, nu))),
                float(norm))


def make_optimizer(model: nn.Module, lr=0.01) -> Optimizer:
    """The JAX ``make_optimizer`` (its defaults) for ``model``'s
    parameters; ``lr`` a number or a schedule (count -> lr)."""
    names = [n for n, _ in model.named_parameters()]
    return Optimizer(frozen_mask(names),
                     lr if callable(lr) else (lambda count: lr))


class TrainState(NamedTuple):
    model: nn.Module  # the parameters, updated in place
    opt_state: OptState
    step: int


@dataclasses.dataclass
class Trainer:
    """The train step for a per-sample loss,
    ``loss_fn(model, sample, rng) -> (loss, metrics)``: the counterpart of
    the JAX ``Trainer`` (``jax.vmap`` of the loss over the batch, then the
    mean) on one card. Each sample's loss is divided by the batch size and
    back-propagated in turn, so gradients add up to the mean's."""

    loss_fn: Callable
    optimizer: Optimizer

    def init_state(self, model: nn.Module) -> TrainState:
        return TrainState(model,
                          self.optimizer.init(dict(model.named_parameters())),
                          0)

    def step(self, state: TrainState, batch, rngs: Sequence
             ) -> Tuple[TrainState, Dict[str, float]]:
        """One step over ``batch`` (a NamedTuple of tensors with a leading
        batch axis B) with one ``rng`` per sample (what ``loss_fn`` takes:
        a generator, or pre-drawn uniforms). Metrics are the per-sample
        means, as host floats, plus ``grad_norm``."""
        model = state.model
        params = dict(model.named_parameters())
        b = len(rngs)
        for p in params.values():
            p.grad = None
        sums: Dict[str, float] = {}
        for i in range(b):
            sample = type(batch)(*(f[i] for f in batch))
            loss, metrics = self.loss_fn(model, sample, rngs[i])
            (loss / b).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach())
        opt_state, norm = self.optimizer.step(params, state.opt_state)
        for p in params.values():
            p.grad = None
        metrics = {k: v / b for k, v in sums.items()}
        metrics["grad_norm"] = norm
        return TrainState(model, opt_state, state.step + 1), metrics
