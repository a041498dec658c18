"""Save and restore a whole ``TrainState`` (the model's ``state_dict``, the
optimizer's momentum and count, the step) with ``torch.save``, the
counterpart of the JAX package's ``utils/checkpoint.py`` for resuming.
Tensors are stored as they are, so a resumed run continues bit for bit."""

from __future__ import annotations

import os

import torch

from ..parallel.train import OptState, TrainState


def save_checkpoint(directory: str, state: TrainState) -> str:
    """Write ``directory/step_<step>.pt``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{state.step}.pt")
    torch.save({"model": state.model.state_dict(),
                "count": state.opt_state.count,
                "trace": state.opt_state.trace,
                "step": state.step}, path)
    return path


def checkpoint_step(path: str) -> int:
    """The step of the checkpoint at ``path``, without reading its
    tensors."""
    return int(torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)["step"])


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore the checkpoint at ``path`` into ``state``'s model (in place)
    and return the state it holds, on the model's device."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    return TrainState(state.model, OptState(ckpt["count"], ckpt["trace"]),
                      ckpt["step"])
