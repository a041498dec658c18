"""Multi-stream SELSA serving on one card, the counterpart of the JAX
package's ``parallel/serve.py`` (``batched_video_state``,
``make_serve_step``).

The JAX step shards a batch of S independent streams over the chips of a
mesh. Here the S streams run batched on the model's device: one step serves
one frame (or one clip) of every stream with one backbone pass and one
launch of each kernel. There is no mesh; ``shard_args`` moves host inputs to
that device. Sharding the streams over several cards is later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.vid.selsa import (
    VideoState,
    empty_video_state,
    inference_clip_batch,
    inference_step_batch,
    stack_video_states,
)
from ..utils.device import resolve_device


def batched_video_state(cfg, n_streams: int, device=None,
                        generator: Optional[torch.Generator] = None
                        ) -> VideoState:
    """An S-stream memo: ``empty_video_state`` stacked on a leading stream
    axis of every leaf (each stream owns its memory), ``next_slot`` an int64
    tensor [S] of zeros. Like ``empty_video_state`` it holds no reference
    maps; for the temporal extractor stack memos from ``init_video_state``
    (``stack_video_states``). ``device`` None puts it on the card and
    raises without one; pass ``device="cpu"`` for the CPU."""
    st = empty_video_state(cfg, device=resolve_device(device),
                           generator=generator)
    return stack_video_states([st] * n_streams)


def make_serve_step(model, clip: bool = True, update_memo: bool = False,
                    frame_stride: int = 1):
    """An S-stream serving step on the model's device.

    Returns (step, shard_args) where
      ``step(anchors, states, frames, img_shapes, scale_factors)``
    runs ``inference_clip_batch`` (clip=True; frames [S, T, H, W, 3]) or
    ``inference_step_batch`` (clip=False; frames [S, H, W, 3]; the memo
    rolls on every call when ``update_memo``) and returns (states,
    DetResult). The step consumes the states it is given, as the JAX step
    donates them: the per-frame step rolls the memo in their tensors, so a
    caller keeps only the returned states. ``shard_args`` moves an
    (anchors, states, frames, img_shapes, scale_factors) tuple of host
    arrays or tensors to the model's device.
    """
    device = next(model.parameters()).device

    def step(anchors, states, frames, img_shapes, scale_factors):
        if clip:
            return inference_clip_batch(
                model, states, frames, img_shapes, scale_factors, anchors,
                update_memo=update_memo, frame_stride=frame_stride)
        return inference_step_batch(
            model, states, frames, img_shapes, scale_factors, anchors,
            update_memo=update_memo)

    def to_device(x):
        return None if x is None else torch.as_tensor(x, device=device)

    def shard_args(anchors, states, frames, img_shapes, scale_factors):
        st = VideoState(
            tuple((to_device(k), to_device(v)) for k, v in states.ref_kv),
            to_device(states.ref_valid), to_device(states.next_slot),
            to_device(states.ref_maps))
        return (to_device(anchors), st, to_device(frames),
                to_device(img_shapes), to_device(scale_factors))

    return step, shard_args
