"""The device the port's entry points build on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``), and
    raises where there is none: a caller who wants the CPU says so."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def full_f32_precision() -> dict:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions, process
    wide, and return the flags. The port's entry points call this (the
    CLIs, ``VIDModel`` and the tracking models, ``train_model``, the
    learning smoke): every check of the port on the card ran so, and
    PyTorch's default runs cuDNN's f32 convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return precision_flags()


def precision_flags() -> dict:
    """The TF32 flags as they stand, for a run's record."""
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
