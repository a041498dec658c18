"""SELSA video object detector, streaming inference: the counterpart of the
JAX package's ``models/vid/selsa.py`` (``SelsaConfig``, ``SelsaDetector``,
``VideoState``, ``make_anchors``, ``empty_video_state``,
``init_video_state``, ``inference_step``, ``inference_clip``,
``init_params``).

Feature maps cross module boundaries NHWC, as in the JAX package; the convs
inside run NCHW views of them. RoIAlign (kernel B) and the two-slab SELSA
attention (kernel A) launch hand-written CUDA kernels on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ...core.anchors import AnchorGenerator
from ...core.nms import DetResult
from ...ops.roi_align import roi_align
from ..backbones.resnet import FrozenBatchNorm, ResNet
from ..dense_heads import rpn_head as rpn
from ..necks.channel_mapper import ChannelMapper
from ..roi_heads import bbox_head as bh


@dataclasses.dataclass(frozen=True)
class SelsaConfig:
    """Static configuration; field names and defaults follow the JAX
    ``SelsaConfig`` (the inference subset)."""

    depth: int = 50
    num_classes: int = 30
    neck_channels: int = 512
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: int = 16
    pad_h: int = 608
    pad_w: int = 1024
    test_nms_pre: int = 2000
    test_nms_post: int = 300
    rpn_nms_iou: float = 0.7
    det_nms_pre: int = 2048
    num_ref_frames: int = 14
    compute_dtype: torch.dtype = torch.bfloat16
    input_packed: int = 0

    def __post_init__(self):
        if self.input_packed:
            raise ValueError("input_packed is a TPU host contract; the port "
                             "takes unpacked frames (input_packed=0)")

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (self.pad_h // self.stride, self.pad_w // self.stride)

    @property
    def num_base_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


class SelsaDetector(nn.Module):
    """Backbone + neck + RPN + SELSA bbox head."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.backbone = ResNet(
            depth=c.depth, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
            out_indices=(3,), dtype=c.compute_dtype)
        self.neck = ChannelMapper(2048, c.neck_channels, 3,
                                  dtype=c.compute_dtype)
        self.rpn_head = rpn.RPNHead(c.neck_channels, c.neck_channels,
                                    c.num_base_anchors, dtype=c.compute_dtype)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * c.neck_channels, c.num_classes, dtype=c.compute_dtype)

    def extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs: [T, H, W, 3] normalized -> neck feature [T, h, w, C]."""
        stage = self.backbone(imgs.permute(0, 3, 1, 2))[-1]
        return self.neck(stage).permute(0, 2, 3, 1).contiguous()

    def rpn_forward(self, neck_feat: torch.Tensor):
        """[T, h, w, C] -> (cls [T, h, w, A], reg [T, h, w, 4A])."""
        return self.rpn_head(neck_feat)

    def roi_feats(self, neck_feat, rois, batch_inds=None,
                  impl: Optional[str] = None):
        """7x7 RoIAlign at the model stride (aligned, sampling_ratio 2) over
        [h, w, C] or [S, h, w, C] maps; kernel B on CUDA tensors."""
        return roi_align(neck_feat, rois.float(), 1.0 / self.cfg.stride,
                         batch_inds=batch_inds, out_size=7, sampling_ratio=2,
                         impl=impl)


def make_anchors(cfg: SelsaConfig, device=None) -> torch.Tensor:
    gen = AnchorGenerator(strides=[cfg.stride], ratios=list(cfg.anchor_ratios),
                          scales=list(cfg.anchor_scales))
    return torch.as_tensor(gen.grid_anchors([cfg.feat_hw])[0], device=device)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal at +-2 sigma, variance
    1 / fan_in after truncation."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(model: SelsaDetector, generator: torch.Generator
                ) -> SelsaDetector:
    """Seeded init with flax's defaults: lecun-normal conv and dense kernels,
    zero biases, FrozenBN scale 1, shift 0, mean 0, var 1. The generator
    must live on the model's device (a CPU generator for a CPU model)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model


@torch.no_grad()
def cast_for_inference(model: SelsaDetector) -> SelsaDetector:
    """Store conv and dense weights and biases in their modules' compute
    dtype (they are cast per use anyway, so the numbers do not change);
    FrozenBN statistics stay f32 and are folded in f32."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.to(mod.compute_dtype)
    return model


class VideoState(NamedTuple):
    """Streaming memo: per shared-FC stage the cached reference K/V, head
    major [nb, S, P, hd]; their validity [S, P]; the fix-stride roll slot."""

    ref_kv: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    ref_valid: torch.Tensor
    next_slot: int


def empty_video_state(cfg: SelsaConfig, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> VideoState:
    """A full-validity memo in the compute dtype; zeros, or N(0, 0.1^2)
    values from ``generator``."""
    head = bh.Shared2FCBBoxHead
    nb, c, dtype = head.num_attention_blocks, head.fc_out_channels, \
        cfg.compute_dtype
    shape = (nb, cfg.num_ref_frames, cfg.test_nms_post, c // nb)

    def one():
        if generator is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=generator, device=device) * 0.1
                ).to(dtype)

    kv = tuple((one(), one()) for _ in range(head.num_shared_fcs))
    valid = torch.ones((cfg.num_ref_frames, cfg.test_nms_post), dtype=torch.bool,
                       device=device)
    return VideoState(kv, valid, 0)


def _proposals(cfg, cls, reg, anchors, img_shape) -> rpn.Proposals:
    return rpn.rpn_proposals(cls, reg, anchors, img_shape,
                             nms_pre=cfg.test_nms_pre,
                             nms_post=cfg.test_nms_post,
                             iou_threshold=cfg.rpn_nms_iou)


@torch.no_grad()
def init_video_state(model: SelsaDetector, ref_imgs: torch.Tensor, img_shape,
                     anchors: torch.Tensor) -> VideoState:
    """Fill the memo from the reference frames ref_imgs [S, H, W, 3]."""
    cfg = model.cfg
    s = ref_imgs.shape[0]
    p = cfg.test_nms_post
    neck = model.extract_feat(ref_imgs)
    cls_all, reg_all = model.rpn_forward(neck)
    props = [_proposals(cfg, cls_all[i], reg_all[i], anchors, img_shape)
             for i in range(s)]
    rois = torch.cat([pr.boxes for pr in props])
    binds = torch.arange(s, device=rois.device).repeat_interleave(p)
    rfeats = model.roi_feats(neck, rois, binds)
    kvs = model.bbox_head.ref_transform_kv(rfeats)
    kvs = tuple((k.reshape(k.shape[0], s, p, -1), v.reshape(v.shape[0], s, p, -1))
                for k, v in kvs)
    return VideoState(kvs, torch.stack([pr.valid for pr in props]), 0)


class StreamHead(NamedTuple):
    """One frame's pre-decode outputs (see ``stream_head``)."""

    proposals: rpn.Proposals
    cls_score: torch.Tensor  # [P, C+1]
    bbox_pred: torch.Tensor  # [P, 4C]
    cur_kvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # [nb, P, hd]


@torch.no_grad()
def stream_head(model: SelsaDetector, state: VideoState, frame: torch.Tensor,
                img_shape, anchors: torch.Tensor,
                impl: Optional[str] = None) -> StreamHead:
    """Backbone, neck, RPN and proposals, RoIAlign and the SELSA head for one
    frame [H, W, 3] against the memo. ``impl="plain"`` runs both kernels'
    plain versions (for comparisons only)."""
    cfg = model.cfg
    neck = model.extract_feat(frame[None])
    cls, reg = model.rpn_forward(neck)
    props = _proposals(cfg, cls[0], reg[0], anchors, img_shape)
    rfeats = model.roi_feats(neck[0], props.boxes, impl=impl)
    ref_kvs = tuple((k.reshape(k.shape[0], -1, k.shape[-1]),
                     v.reshape(v.shape[0], -1, v.shape[-1]))
                    for k, v in state.ref_kv)
    (cls_score, bbox_pred), cur_kvs = model.bbox_head.forward_cached_stream_kv(
        rfeats, ref_kvs, state.ref_valid.reshape(-1), props.valid, impl=impl)
    return StreamHead(props, cls_score, bbox_pred, cur_kvs)


@torch.no_grad()
def inference_step(model: SelsaDetector, state: VideoState,
                   frame: torch.Tensor, img_shape, scale_factor,
                   anchors: torch.Tensor, update_memo: bool = False,
                   do_update: bool = True) -> Tuple[VideoState, DetResult]:
    """One streamed frame [H, W, 3] -> (state, DetResult).

    With ``update_memo`` (fix-stride mode) and ``do_update``, this frame's
    K/V replace the oldest memo slot. The roll writes the memo tensors in
    place (the JAX step returns new arrays) to avoid copying the memo every
    frame; the returned state shares them."""
    cfg = model.cfg
    out = stream_head(model, state, frame, img_shape, anchors)
    props = out.proposals
    dets = bh.bbox_decode(props.boxes, out.cls_score, out.bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor,
                          nms_pre=cfg.det_nms_pre)
    if update_memo and do_update:
        slot = state.next_slot
        for (bk, bv), (ck, cv) in zip(state.ref_kv, out.cur_kvs):
            bk[:, slot] = ck.to(bk.dtype)
            bv[:, slot] = cv.to(bv.dtype)
        state.ref_valid[slot] = props.valid
        state = VideoState(state.ref_kv, state.ref_valid,
                           (slot + 1) % state.ref_valid.shape[0])
    return state, dets


def inference_clip(model: SelsaDetector, state: VideoState,
                   frames: torch.Tensor, img_shape, scale_factor,
                   anchors: torch.Tensor, update_memo: bool = False,
                   frame_stride: int = 1) -> Tuple[VideoState, DetResult]:
    """Stream frames [T, H, W, 3] in order; the fix-stride roll happens on
    frames t with t % frame_stride == 0. Returns the final state and the
    DetResult fields stacked over frames."""
    dets = []
    for t in range(frames.shape[0]):
        state, d = inference_step(model, state, frames[t], img_shape,
                                  scale_factor, anchors,
                                  update_memo=update_memo,
                                  do_update=t % frame_stride == 0)
        dets.append(d)
    return state, DetResult(*(torch.stack(f) for f in zip(*dets)))
