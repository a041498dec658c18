"""FGFA and DFF, the flow-based video detectors, the counterpart of the JAX
package's ``models/vid/fgfa.py`` (``FGFA``, ``fgfa_loss``, ``FGFAState``,
``fgfa_init_state``, ``fgfa_inference_step``, ``DFF``, ``dff_loss``,
``DFFState``, ``dff_inference_step``, ``make_fgfa``, ``make_dff``).

- FGFA: FlowNetSimple's flow from the key frame to each reference frame
  (the pair stacked on the channels, key first), each reference's neck map
  warped by its flow (``ops/grid_sample.flow_warp_feats``), the
  EmbedAggregator's cosine-weighted sum of the key's and the warped maps,
  then Faster R-CNN on the aggregate. Streaming keeps the last
  ``num_ref_frames`` frames and their neck maps and rolls one slot every
  frame.
- DFF: the backbone runs on key frames only (every ``key_frame_interval``
  frames); another frame gets the key's neck map warped by the flow of the
  pair (frame, key).

The flow network, the warp and the aggregator compute in float32; the
backbone, neck and RPN in the config's ``compute_dtype``; the bbox head in
float32 on RoIAlign of the float32 map (kernel B, and kernel D for its
gradient, on CUDA tensors). Proposals carry no gradient (ROADMAP F6).

The streaming state keeps its counters (``next_slot``,
``frames_since_key``) as host ints, so choosing the key or the warp branch
costs no sync; the JAX step carries them as int32 device arrays under a
``lax.cond``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...ops.grid_sample import flow_warp_feats
from ..detectors.faster_rcnn import FasterRCNN, rcnn_detect, rcnn_loss
from ..motion.flownet_simple import EmbedAggregator, FlowNetSimple
from .selsa import (LossUniforms, SelsaConfig, TrainBatch, loss_uniforms,
                    place)


class FGFA(nn.Module):
    """``detector`` (Faster R-CNN), ``motion`` (FlowNetSimple) and
    ``aggregator`` (EmbedAggregator), named as the flax tree."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.detector = FasterRCNN(cfg)
        self.motion = FlowNetSimple(img_scale_factor=0.5)
        self.aggregator = EmbedAggregator(cfg.neck_channels,
                                          cfg.neck_channels)

    def extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] -> neck maps [T, h, w, C]."""
        return self.detector.extract_feat(imgs)

    def compute_flow(self, key_img: torch.Tensor,
                     ref_imgs: torch.Tensor) -> torch.Tensor:
        """key_img [H, W, 3], ref_imgs [R, H, W, 3] -> flows [R, H', W', 2]
        of the pairs (key, reference)."""
        pairs = torch.cat([key_img[None].expand_as(ref_imgs), ref_imgs], -1)
        return self.motion(pairs)

    def aggregate(self, key_feat: torch.Tensor, ref_feats: torch.Tensor,
                  flows: torch.Tensor) -> torch.Tensor:
        """Warp each reference map ref_feats [R, h, w, C] by its flow
        [R, H', W', 2] and fuse them with the key's map [h, w, C] ->
        [h, w, C] float32."""
        warped = flow_warp_feats(ref_feats, flows)
        stack = torch.cat([key_feat[None].float(), warped])
        return self.aggregator(key_feat[None], stack)[0]


def fgfa_loss(model: FGFA, batch: TrainBatch, anchors: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[LossUniforms] = None,
              impl: Optional[str] = None):
    """FGFA's training loss on a key frame and its references (batch.imgs
    [1+R, H, W, 3], key first): the reference maps warped to the key and
    aggregated, then Faster R-CNN's losses on the aggregate. The samplers
    use ``uniforms``, or else draw them from ``generator``; ``impl="plain"``
    runs RoIAlign's plain version (for comparisons only). Returns (total,
    metrics)."""
    uniforms = loss_uniforms(model.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    neck = model.extract_feat(batch.imgs)
    flows = model.compute_flow(batch.imgs[0], batch.imgs[1:])
    agg = model.aggregate(neck[0], neck[1:], flows)
    return rcnn_loss(model.detector, agg[None], batch, anchors, uniforms,
                     impl=impl)


class FGFAState(NamedTuple):
    """The streaming memo: the last S frames and their neck maps, and the
    slot the next frame replaces."""

    ref_imgs: torch.Tensor  # [S, H, W, 3]
    ref_feats: torch.Tensor  # [S, h, w, C], the compute dtype
    next_slot: int


@torch.no_grad()
def fgfa_init_state(model: FGFA, ref_imgs: torch.Tensor) -> FGFAState:
    """The memo of the reference frames ref_imgs [S, H, W, 3] (copied: the
    step writes the memo in place)."""
    return FGFAState(ref_imgs.clone(), model.extract_feat(ref_imgs), 0)


@torch.no_grad()
def fgfa_inference_step(model: FGFA, state: FGFAState, frame: torch.Tensor,
                        img_shape, scale_factor, anchors: torch.Tensor,
                        update_memo: bool = True,
                        impl: Optional[str] = None):
    """One streamed frame [H, W, 3]: every memo map warped to it and
    aggregated with its own, then detected. With ``update_memo`` the frame
    and its map replace slot ``next_slot``, written in place into the
    state's tensors (the returned state shares them). Returns (state,
    DetResult)."""
    key_feat = model.extract_feat(frame[None])[0]
    flows = model.compute_flow(frame, state.ref_imgs)
    agg = model.aggregate(key_feat, state.ref_feats, flows)
    dets = rcnn_detect(model.detector, agg[None], img_shape, scale_factor,
                       anchors, impl=impl)
    if update_memo:
        slot = state.next_slot
        state.ref_imgs[slot] = frame
        state.ref_feats[slot] = key_feat
        state = FGFAState(state.ref_imgs, state.ref_feats,
                          (slot + 1) % state.ref_imgs.shape[0])
    return state, dets


class DFF(nn.Module):
    """``detector`` (Faster R-CNN) and ``motion`` (FlowNetSimple), named as
    the flax tree; the backbone runs every ``key_frame_interval`` frames."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig(),
                 key_frame_interval: int = 10):
        super().__init__()
        self.cfg = cfg
        self.key_frame_interval = key_frame_interval
        self.detector = FasterRCNN(cfg)
        self.motion = FlowNetSimple(img_scale_factor=0.5)

    def extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.detector.extract_feat(imgs)

    def warp_from_key(self, key_img: torch.Tensor, key_feat: torch.Tensor,
                      frame: torch.Tensor) -> torch.Tensor:
        """The key's map [h, w, C] warped to ``frame`` by the flow of the
        pair (frame, key_img) -> [h, w, C] float32."""
        flow = self.motion(torch.cat([frame, key_img], -1)[None])[0]
        return flow_warp_feats(key_feat, flow)


def dff_loss(model: DFF, batch: TrainBatch, anchors: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             uniforms: Optional[LossUniforms] = None,
             impl: Optional[str] = None):
    """DFF's training loss: the reference frame (index 1) is the key; its
    map, warped to the annotated frame (index 0), takes Faster R-CNN's
    losses. ``generator``, ``uniforms`` and ``impl`` as in ``fgfa_loss``.
    Returns (total, metrics)."""
    uniforms = loss_uniforms(model.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    key_feat = model.extract_feat(batch.imgs[1:2])[0]
    warped = model.warp_from_key(batch.imgs[1], key_feat, batch.imgs[0])
    return rcnn_loss(model.detector, warped[None], batch, anchors, uniforms,
                     impl=impl)


class DFFState(NamedTuple):
    """The last key frame and its neck map (None before the first), and
    the frames streamed since it."""

    key_img: Optional[torch.Tensor]  # [H, W, 3]
    key_feat: Optional[torch.Tensor]  # [h, w, C], the compute dtype
    frames_since_key: int


def dff_init_state() -> DFFState:
    """Before frame 0, which is a key frame."""
    return DFFState(None, None, 0)


@torch.no_grad()
def dff_inference_step(model: DFF, state: DFFState, frame: torch.Tensor,
                       img_shape, scale_factor, anchors: torch.Tensor,
                       impl: Optional[str] = None):
    """One streamed frame [H, W, 3]: a key frame (every
    ``key_frame_interval``-th since the state's start) runs the backbone
    and becomes the key; another warps the key's map to it. Both maps are
    cast to the compute dtype, then detected. Returns (state, DetResult)."""
    dtype = model.cfg.compute_dtype
    if state.frames_since_key % model.key_frame_interval == 0:
        feat = model.extract_feat(frame[None])[0].to(dtype)
        key_img, key_feat = frame, feat
    else:
        feat = model.warp_from_key(state.key_img, state.key_feat,
                                   frame).to(dtype)
        key_img, key_feat = state.key_img, state.key_feat
    dets = rcnn_detect(model.detector, feat[None], img_shape, scale_factor,
                       anchors, impl=impl)
    return DFFState(key_img, key_feat, state.frames_since_key + 1), dets


def make_fgfa(cfg: Optional[SelsaConfig] = None,
              generator: Optional[torch.Generator] = None, device=None):
    """(model, anchors): ``FGFA`` placed as ``selsa.place`` says."""
    cfg = cfg or SelsaConfig()
    return place(FGFA(cfg), cfg, generator, device)


def make_dff(cfg: Optional[SelsaConfig] = None, key_frame_interval: int = 10,
             generator: Optional[torch.Generator] = None, device=None):
    """(model, anchors): ``DFF`` placed as ``selsa.place`` says."""
    cfg = cfg or SelsaConfig()
    return place(DFF(cfg, key_frame_interval), cfg, generator, device)

