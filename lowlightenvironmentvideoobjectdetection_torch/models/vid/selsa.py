"""SELSA video object detector, training loss and streaming inference: the
counterpart of the JAX package's ``models/vid/selsa.py`` (``SelsaConfig``,
``SelsaDetector``, ``TrainBatch``, ``selsa_loss``, ``VideoState``,
``make_anchors``, ``empty_video_state``, ``init_video_state``,
``inference_step``, ``inference_clip``, ``inference_clip_batch``,
``init_params``, ``make_selsa``).

Multi-stream serving: a ``VideoState`` with a leading stream axis S on every
leaf holds S independent memos, and ``inference_step_batch`` (the
counterpart of ``jax.vmap(inference_step)``) serves one frame of each stream
with one backbone pass, one RPN, one proposal NMS, one RoIAlign launch over
the S maps and one attention launch per head stage. The single-stream
functions are its S = 1 case.

Feature maps cross module boundaries NHWC, as in the JAX package; the convs
inside run NCHW views of them (the backbone's stage outputs stay NCHW).
RoIAlign (kernel B, and kernel D for its gradient) and the two-slab SELSA
attention (kernel A) launch hand-written CUDA kernels on CUDA tensors.

With ``roi_extractor="temporal"`` the key-frame rois go through
TemporalRoIAlign against the reference frames' neck maps: in the loss
against the batch's reference frames, when streaming against the maps the
memo keeps (``VideoState.ref_maps``).

With ``backbone_variant`` the backbone is one of the dark backbones
(``backbones/dark_resnet.py``), whose ConvLSTM stages and plugins mix the
frames of a clip: training takes the key and its references as one clip
(the key first), the memo fill the references as one clip, and a streamed
step each stream's frame as a clip of its own, as the JAX package streams
one frame at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...core.anchors import AnchorGenerator
from ...core.nms import DetResult
from ...ops.roi_align import roi_align
from ...utils.device import resolve_device
from ..backbones.dark_resnet import make_dark_backbone
from ..backbones.resnet import FrozenBatchNorm, ResNet
from ..dense_heads import rpn_head as rpn
from ..necks.channel_mapper import ChannelMapper
from ..roi_heads import bbox_head as bh
from ..roi_heads.temporal_roi_align import TemporalRoIAlign


@dataclasses.dataclass(frozen=True)
class SelsaConfig:
    """Static configuration; field names and defaults follow the JAX
    ``SelsaConfig`` (the subset the port runs)."""

    depth: int = 50
    num_classes: int = 30
    neck_channels: int = 512
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: int = 16
    pad_h: int = 608
    pad_w: int = 1024
    train_nms_pre: int = 6000
    train_nms_post: int = 600
    test_nms_pre: int = 2000
    test_nms_post: int = 300
    rpn_nms_iou: float = 0.7
    det_nms_pre: int = 2048
    num_roi_samples: int = 256
    num_ref_frames: int = 14
    # stem and stages 1..frozen_stages take no gradient (-1: none frozen)
    frozen_stages: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    # bbox-head dtype (None = follow compute_dtype); also the memo's dtype
    head_dtype: Optional[torch.dtype] = None
    input_packed: int = 0
    # backbone stages returned by ``extract_feats`` (duplicates allowed; the
    # last feeds the neck), e.g. (0, 1, 2, 3, 3) for the feature losses
    out_indices: Tuple[int, ...] = (3,)
    backbone_in_channels: int = 3  # 4 for RAW (RGGB) input
    # None: the plain ResNet; else a dark-backbone variant of
    # ``backbones/dark_resnet.py`` (DarkResNet, ResNet_A, ResNetC, ...) with
    # extra ``DarkResNet`` arguments as (key, value) pairs, e.g. the
    # insert-plugins configs' plugin_stages and plugin_type="aggregator"
    backbone_variant: Optional[str] = None
    backbone_overrides: Tuple[Tuple[str, Any], ...] = ()
    # key-roi extractor: 'single' (plain RoIAlign) or 'temporal'
    # (TemporalRoIAlign over the reference maps); reference rois stay plain
    roi_extractor: str = "single"
    troi_similar_points: int = 2
    troi_attention_blocks: int = 4
    num_shared_fcs: int = 2  # 3 in the TemporalRoIAlign configurations

    def __post_init__(self):
        if self.input_packed:
            raise ValueError("input_packed is a TPU host contract; the port "
                             "takes unpacked frames (input_packed=0)")
        if self.roi_extractor not in ("single", "temporal"):
            raise ValueError(f"unknown roi_extractor {self.roi_extractor!r}")

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (self.pad_h // self.stride, self.pad_w // self.stride)

    @property
    def num_base_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def bbox_head_dtype(self) -> torch.dtype:
        return (self.head_dtype if self.head_dtype is not None
                else self.compute_dtype)


class SelsaDetector(nn.Module):
    """Backbone + neck + RPN + SELSA bbox head (+ TemporalRoIAlign)."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = c = cfg
        backbone = dict(
            depth=c.depth, in_channels=c.backbone_in_channels,
            strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
            out_indices=c.out_indices, frozen_stages=c.frozen_stages,
            dtype=c.compute_dtype)
        if c.backbone_variant is None:
            self.backbone = ResNet(**backbone)
        else:
            self.backbone = make_dark_backbone(
                c.backbone_variant, **backbone, **dict(c.backbone_overrides))
        self.neck = ChannelMapper(256 * 2 ** c.out_indices[-1],
                                  c.neck_channels, 3, dtype=c.compute_dtype)
        self.rpn_head = rpn.RPNHead(c.neck_channels, c.neck_channels,
                                    c.num_base_anchors, dtype=c.compute_dtype)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * c.neck_channels, c.num_classes,
            num_shared_fcs=c.num_shared_fcs, dtype=c.bbox_head_dtype)
        if c.roi_extractor == "temporal":
            self.troi = TemporalRoIAlign(
                c.neck_channels, c.troi_similar_points,
                c.troi_attention_blocks, dtype=c.compute_dtype)

    def extract_feats(self, imgs: torch.Tensor,
                      clip_len: Optional[int] = None,
                      impl: Optional[str] = None):
        """imgs: [T, H, W, Cin] normalized -> (the backbone stages of
        ``cfg.out_indices``, NCHW; the neck feature [T, h, w, C]). A dark
        backbone takes the T frames as clips of ``clip_len`` frames in order
        (None: one clip); ``impl="plain"`` runs its DCN's plain version."""
        stages = self.backbone(imgs.permute(0, 3, 1, 2), clip_len=clip_len,
                               impl=impl)
        return stages, self.neck(stages[-1]).permute(0, 2, 3, 1).contiguous()

    def extract_feat(self, imgs: torch.Tensor, clip_len: Optional[int] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
        """imgs: [T, H, W, Cin] normalized -> neck feature [T, h, w, C]."""
        return self.extract_feats(imgs, clip_len, impl)[1]

    def rpn_forward(self, neck_feat: torch.Tensor):
        """[T, h, w, C] -> (cls [T, h, w, A], reg [T, h, w, 4A])."""
        return self.rpn_head(neck_feat)

    def roi_feats(self, neck_feat, rois, batch_inds=None,
                  impl: Optional[str] = None):
        """7x7 RoIAlign at the model stride (aligned, sampling_ratio 2) over
        [h, w, C] or [S, h, w, C] maps; kernel B on CUDA tensors, kernel D
        for the maps' gradient."""
        return roi_align(neck_feat, rois.float(), 1.0 / self.cfg.stride,
                         batch_inds=batch_inds, out_size=7, sampling_ratio=2,
                         impl=impl)

    def roi_feats_troi(self, neck_feat, rois, ref_maps, batch_inds=None,
                       impl: Optional[str] = None):
        """Key-frame roi features: the plain RoIAlign on ``neck_feat``, then
        TemporalRoIAlign against the reference maps ``ref_maps`` [R, h, w, C]
        (batched: rois of S maps in map order, [S, R, h, w, C])."""
        rf = self.roi_feats(neck_feat, rois, batch_inds, impl=impl)
        if ref_maps is not None and ref_maps.ndim == 5:
            rf = rf.reshape(ref_maps.shape[0], -1, *rf.shape[1:])
        return self.troi(rf, ref_maps)


def make_anchors(cfg: SelsaConfig, device=None) -> torch.Tensor:
    gen = AnchorGenerator(strides=[cfg.stride], ratios=list(cfg.anchor_ratios),
                          scales=list(cfg.anchor_scales))
    return torch.as_tensor(gen.grid_anchors([cfg.feat_hw])[0], device=device)


def place(model: nn.Module, cfg: SelsaConfig,
          generator: Optional[torch.Generator], device):
    """(model, anchors of ``cfg``): the model with seeded flax-style weights
    from ``generator`` (a CPU generator; None leaves PyTorch's init), on
    ``device`` (None: the card, raising without one)."""
    device = resolve_device(device)
    if generator is not None:
        init_params(model, generator)
    return model.to(device), make_anchors(cfg, device)


def make_selsa(cfg: Optional[SelsaConfig] = None,
               generator: Optional[torch.Generator] = None, device=None):
    """(model, anchors): ``SelsaDetector`` placed as ``place`` says."""
    cfg = cfg or SelsaConfig()
    return place(SelsaDetector(cfg), cfg, generator, device)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                   fan_in: Optional[int] = None) -> None:
    """flax's ``lecun_normal``: truncated normal at +-2 sigma, variance
    1 / fan_in after truncation (fan_in: one output's inputs, by default
    the size of ``w[0]``)."""
    fan_in = fan_in or w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(model: SelsaDetector, generator: torch.Generator
                ) -> SelsaDetector:
    """Seeded init with flax's defaults: lecun-normal conv, transposed conv
    and dense kernels, zero biases, FrozenBN scale 1, shift 0, mean 0, var
    1; then each module with an ``init_flax`` (a DCN pack: a zero
    ``conv_offset``, a uniform raw ``weight``) its own. The generator must
    live on the model's device (a CPU generator for a CPU model)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            # a transposed conv's weight is [in, out, kh, kw]; flax's
            # kernel [kh, kw, in, out] has fan_in kh * kw * in
            fan_in = (mod.weight[:, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else None)
            _lecun_normal_(mod.weight, generator, fan_in)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for mod in model.modules():  # after the convs: conv_offset is one
        if hasattr(mod, "init_flax"):
            mod.init_flax(generator)
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


class TrainBatch(NamedTuple):
    """One video training sample: a key frame and R reference frames."""

    imgs: torch.Tensor  # [1+R, H, W, 3] normalized, padded; index 0 = key
    img_shape: torch.Tensor  # [2] (h, w) of the unpadded content
    gt_boxes: torch.Tensor  # [G, 4] key-frame gts (padded)
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool


class LossUniforms(NamedTuple):
    """The uniforms [0, 1) that ``selsa_loss`` samples with: the RPN
    sampler's ranks over the anchors and the RoI sampler's ranks and
    tiebreak over the gts and key proposals (``core/assigners.py``)."""

    rpn: torch.Tensor  # [2, A]
    roi: torch.Tensor  # [3, G + train_nms_post]


def draw_loss_uniforms(cfg: SelsaConfig, num_gts: int,
                       generator: torch.Generator, device=None
                       ) -> LossUniforms:
    """``LossUniforms`` drawn from ``generator`` (on its device), moved to
    ``device``."""
    h, w = cfg.feat_hw
    a = h * w * cfg.num_base_anchors
    gdev = generator.device
    return LossUniforms(
        torch.rand((2, a), generator=generator, device=gdev).to(device),
        torch.rand((3, num_gts + cfg.train_nms_post), generator=generator,
                   device=gdev).to(device))


def loss_uniforms(cfg: SelsaConfig, num_gts: int, anchors: torch.Tensor,
                  generator: Optional[torch.Generator],
                  uniforms: Optional[LossUniforms]) -> LossUniforms:
    """``uniforms``, or else ``LossUniforms`` drawn from ``generator``."""
    if uniforms is not None:
        return uniforms
    if generator is None:
        raise ValueError("pass uniforms or a generator")
    return draw_loss_uniforms(cfg, num_gts, generator, anchors.device)


def selsa_loss(model: SelsaDetector, batch: TrainBatch, anchors: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[LossUniforms] = None,
               impl: Optional[str] = None):
    """Single-sample SELSA training loss (mmtracking's SELSA forward_train):
    the RPN loss on the key frame; proposals on the key frame (train NMS
    window) and on each reference frame (test window); sampled RoI targets
    on the key frame; RoIAlign of the key rois (TemporalRoIAlign against
    the reference maps with ``roi_extractor="temporal"``) and of all
    reference proposals; the joint SELSA head and its loss. Returns (total,
    metrics).

    The samplers use ``uniforms``, or else draw them from ``generator``.
    The proposals carry no gradient, as in the original (mmdet detaches
    the RPN outputs before decoding, and RoIAlign has no roi gradient);
    the JAX package differentiates through them (ROADMAP fault F6).
    ``impl="plain"`` runs the plain versions of RoIAlign and of a dark
    backbone's DCN (for comparisons only)."""
    uniforms = loss_uniforms(model.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    neck = model.extract_feat(batch.imgs, impl=impl)
    return detection_loss(model, neck, batch, anchors, uniforms, impl=impl)


def detection_loss(model: SelsaDetector, neck: torch.Tensor, batch,
                   anchors: torch.Tensor, uniforms: LossUniforms,
                   impl: Optional[str] = None, total=0.0):
    """``selsa_loss`` from the neck features [1+R, h, w, C] on: ``batch``
    gives ``img_shape`` and the gts. The four losses are added to
    ``total`` in order. Returns (total, metrics)."""
    cfg = model.cfg
    cls_all, reg_all = model.rpn_forward(neck)
    rpn_losses = rpn.rpn_loss(cls_all[0], reg_all[0], anchors,
                              batch.gt_boxes, batch.gt_valid, uniforms.rpn,
                              batch.img_shape)
    num_refs = neck.shape[0] - 1
    with torch.no_grad():  # F6: no gradient through the proposals
        key_props = rpn.rpn_proposals(
            cls_all[0], reg_all[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=cfg.rpn_nms_iou)
        ref_props = rpn.rpn_proposals(
            cls_all[1:], reg_all[1:], anchors,
            batch.img_shape.expand(num_refs, 2), nms_pre=cfg.test_nms_pre,
            nms_post=cfg.test_nms_post, iou_threshold=cfg.rpn_nms_iou)
    tgts = bh.bbox_targets(key_props.boxes, key_props.valid, batch.gt_boxes,
                           batch.gt_labels, batch.gt_valid, uniforms.roi,
                           num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples)
    if cfg.roi_extractor == "temporal":
        key_feats = model.roi_feats_troi(neck[0], tgts.rois, neck[1:],
                                         impl=impl)
    else:
        key_feats = model.roi_feats(neck[0], tgts.rois, impl=impl)
    binds = torch.arange(num_refs, device=neck.device).repeat_interleave(
        cfg.test_nms_post)
    ref_feats = model.roi_feats(neck[1:], ref_props.boxes.reshape(-1, 4),
                                binds, impl=impl)
    cls_score, bbox_pred = model.bbox_head(key_feats, ref_feats,
                                           ref_props.valid.reshape(-1))
    roi_losses = bh.bbox_loss(cls_score, bbox_pred, tgts,
                              num_classes=cfg.num_classes)
    total = (total + rpn_losses.loss_cls + rpn_losses.loss_bbox
             + roi_losses.loss_cls + roi_losses.loss_bbox)
    metrics = {
        "loss": total,
        "loss_rpn_cls": rpn_losses.loss_cls,
        "loss_rpn_bbox": rpn_losses.loss_bbox,
        "loss_cls": roi_losses.loss_cls,
        "loss_bbox": roi_losses.loss_bbox,
        "acc": roi_losses.acc,
    }
    return total, metrics


class VideoState(NamedTuple):
    """Streaming memo: per shared-FC stage the cached reference K/V, head
    major [nb, R, P, hd] for R reference frames; their validity [R, P]; the
    fix-stride roll slot; with the temporal extractor the reference frames'
    neck maps [R, h, w, C] in the compute dtype (None otherwise). Batched
    over S streams: [S, nb, R, P, hd], [S, R, P], an int64 tensor [S] of
    slots and [S, R, h, w, C]."""

    ref_kv: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    ref_valid: torch.Tensor
    next_slot: "int | torch.Tensor"
    ref_maps: Optional[torch.Tensor] = None


def empty_video_state(cfg: SelsaConfig, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> VideoState:
    """A full-validity memo of ``cfg.num_shared_fcs`` K/V stages in the bbox
    head's dtype; zeros, or N(0, 0.1^2) values from ``generator`` (drawn on
    the generator's device, then moved to ``device``). It holds no
    reference maps: the temporal extractor then passes the roi features
    through, as in JAX. (The JAX ``empty_video_state`` gives 2 stages
    whatever the config, ROADMAP fault F8.)"""
    head = bh.Shared2FCBBoxHead
    nb, c, dtype = head.num_attention_blocks, head.fc_out_channels, \
        cfg.bbox_head_dtype
    shape = (nb, cfg.num_ref_frames, cfg.test_nms_post, c // nb)

    def one():
        if generator is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * 0.1
                ).to(device=device, dtype=dtype)

    kv = tuple((one(), one()) for _ in range(cfg.num_shared_fcs))
    valid = torch.ones((cfg.num_ref_frames, cfg.test_nms_post), dtype=torch.bool,
                       device=device)
    return VideoState(kv, valid, 0)


def stack_video_states(states: Sequence[VideoState]) -> VideoState:
    """Per-stream states -> one batched state (a copy): a leading stream
    axis on every leaf, ``next_slot`` an int64 tensor [S]."""
    kv = tuple(tuple(torch.stack([st.ref_kv[i][j] for st in states])
                     for j in range(2))
               for i in range(len(states[0].ref_kv)))
    valid = torch.stack([st.ref_valid for st in states])
    slots = torch.tensor([int(st.next_slot) for st in states],
                         dtype=torch.int64, device=valid.device)
    maps = (None if states[0].ref_maps is None
            else torch.stack([st.ref_maps for st in states]))
    return VideoState(kv, valid, slots, maps)


def copy_video_state(state: VideoState) -> VideoState:
    """A copy that owns its memory (single or batched)."""
    slot = state.next_slot
    maps = state.ref_maps
    return VideoState(tuple((k.clone(), v.clone()) for k, v in state.ref_kv),
                      state.ref_valid.clone(),
                      slot.clone() if torch.is_tensor(slot) else slot,
                      None if maps is None else maps.clone())


def _proposals(cfg, cls, reg, anchors, img_shape) -> rpn.Proposals:
    return rpn.rpn_proposals(cls, reg, anchors, img_shape,
                             nms_pre=cfg.test_nms_pre,
                             nms_post=cfg.test_nms_post,
                             iou_threshold=cfg.rpn_nms_iou)


@torch.no_grad()
def init_video_state(model: SelsaDetector, ref_imgs: torch.Tensor, img_shape,
                     anchors: torch.Tensor,
                     impl: Optional[str] = None) -> VideoState:
    """Fill the memo from the reference frames ref_imgs [R, H, W, Cin] (one
    proposal NMS for all R); the temporal extractor also keeps their neck
    maps. A dark backbone takes the R frames as one clip, in their order.
    ``impl="plain"`` runs the plain versions of RoIAlign and of a dark
    backbone's DCN (for comparisons only)."""
    cfg = model.cfg
    r = ref_imgs.shape[0]
    p = cfg.test_nms_post
    neck = model.extract_feat(ref_imgs, impl=impl)  # one clip of R frames
    cls_all, reg_all = model.rpn_forward(neck)
    shapes = torch.as_tensor(img_shape, dtype=torch.float32,
                             device=neck.device).expand(r, 2)
    props = _proposals(cfg, cls_all, reg_all, anchors, shapes)
    binds = torch.arange(r, device=neck.device).repeat_interleave(p)
    rfeats = model.roi_feats(neck, props.boxes.reshape(-1, 4), binds,
                             impl=impl)
    kvs = model.bbox_head.ref_transform_kv(rfeats)
    kvs = tuple((k.reshape(k.shape[0], r, p, -1), v.reshape(v.shape[0], r, p, -1))
                for k, v in kvs)
    maps = neck if cfg.roi_extractor == "temporal" else None
    return VideoState(kvs, props.valid, 0, maps)


class StreamHead(NamedTuple):
    """One frame's pre-decode outputs (see ``stream_head``); batched, every
    field has a leading stream axis."""

    proposals: rpn.Proposals
    cls_score: torch.Tensor  # [P, C+1]
    bbox_pred: torch.Tensor  # [P, 4C]
    cur_kvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # [nb, P, hd]
    neck: torch.Tensor  # [h, w, C], what the roll writes into ref_maps


@torch.no_grad()
def stream_head_batch(model: SelsaDetector, states: VideoState,
                      frames: torch.Tensor, img_shapes: torch.Tensor,
                      anchors: torch.Tensor,
                      impl: Optional[str] = None) -> StreamHead:
    """Backbone, neck, RPN and proposals, RoIAlign (then TemporalRoIAlign
    against each stream's own memo maps, with the temporal extractor) and
    the SELSA head for one frame of each of S streams, frames
    [S, H, W, Cin] and img_shapes [S, 2], against the batched memo
    ``states``. A dark backbone takes the frames as S clips of one frame,
    so no stream sees another. ``impl="plain"`` runs the kernels' plain
    versions (for comparisons only)."""
    cfg = model.cfg
    s = frames.shape[0]
    neck = model.extract_feat(frames, clip_len=1, impl=impl)  # S clips
    cls, reg = model.rpn_forward(neck)
    props = _proposals(cfg, cls, reg, anchors, img_shapes)
    p = props.boxes.shape[1]
    binds = torch.arange(s, device=neck.device).repeat_interleave(p)
    if cfg.roi_extractor == "temporal":
        rfeats = model.roi_feats_troi(neck, props.boxes.reshape(-1, 4),
                                      states.ref_maps, binds, impl=impl)
    else:
        rfeats = model.roi_feats(neck, props.boxes.reshape(-1, 4), binds,
                                 impl=impl)
    ref_kvs = tuple((k.flatten(-3, -2), v.flatten(-3, -2))
                    for k, v in states.ref_kv)  # [S, nb, R*P, hd]
    (cls_score, bbox_pred), cur_kvs = model.bbox_head.forward_cached_stream_kv(
        rfeats.reshape(s, p, *rfeats.shape[-3:]), ref_kvs,
        states.ref_valid.flatten(-2), props.valid, impl=impl)
    return StreamHead(props, cls_score, bbox_pred, cur_kvs, neck)


def roll_memo(states: VideoState, cur_kvs, valid: torch.Tensor,
              neck: Optional[torch.Tensor] = None) -> VideoState:
    """The fix-stride roll of a batched memo: each stream's current K/V
    cur_kvs [S, nb, P, hd], proposal validity [S, P] and, where the memo
    keeps maps, neck map [S, h, w, C] replace its slot ``next_slot[s]``.
    Writes the memo tensors in place (the JAX step returns new arrays) to
    avoid copying the memo every frame; the returned state shares them."""
    ar = torch.arange(valid.shape[0], device=valid.device)
    slot = states.next_slot
    for (bk, bv), (ck, cv) in zip(states.ref_kv, cur_kvs):
        bk[ar, :, slot] = ck.to(bk.dtype)
        bv[ar, :, slot] = cv.to(bv.dtype)
    states.ref_valid[ar, slot] = valid
    if states.ref_maps is not None:
        if neck is None:
            raise ValueError("roll_memo: the memo keeps maps; pass neck")
        states.ref_maps[ar, slot] = neck.to(states.ref_maps.dtype)
    return VideoState(states.ref_kv, states.ref_valid,
                      (slot + 1) % states.ref_valid.shape[1], states.ref_maps)


@torch.no_grad()
def inference_step_batch(model: SelsaDetector, states: VideoState,
                         frames: torch.Tensor, img_shapes: torch.Tensor,
                         scale_factors: Optional[torch.Tensor],
                         anchors: torch.Tensor, update_memo: bool = False,
                         do_update: bool = True, impl: Optional[str] = None
                         ) -> Tuple[VideoState, DetResult]:
    """One frame of each of S streams, frames [S, H, W, 3], img_shapes
    [S, 2], scale_factors [S, 4] -> (states, DetResult [S, 100, ...]): the
    counterpart of ``jax.vmap(inference_step)``. With ``update_memo`` and
    ``do_update`` the memo of every stream rolls at its own ``next_slot``,
    in place (see ``roll_memo``). ``impl`` as in ``stream_head_batch``."""
    cfg = model.cfg
    out = stream_head_batch(model, states, frames, img_shapes, anchors,
                            impl=impl)
    props = out.proposals
    dets = bh.bbox_decode(props.boxes, out.cls_score, out.bbox_pred,
                          img_shapes, roi_valid=props.valid,
                          scale_factor=scale_factors, nms_pre=cfg.det_nms_pre)
    if update_memo and do_update:
        states = roll_memo(states, out.cur_kvs, props.valid, out.neck)
    return states, dets


def inference_clip_batch(model: SelsaDetector, states: VideoState,
                         frames: torch.Tensor, img_shapes: torch.Tensor,
                         scale_factors: Optional[torch.Tensor],
                         anchors: torch.Tensor, update_memo: bool = False,
                         frame_stride: int = 1
                         ) -> Tuple[VideoState, DetResult]:
    """Multi-stream clips, frames [S, T, H, W, 3], streamed frame by frame
    through ``inference_step_batch``; the roll happens on frames t with
    t % frame_stride == 0. Returns the final states and the DetResult
    fields stacked as [S, T, ...]. The given states are left as they are:
    with ``update_memo`` the memo is copied once per clip."""
    if update_memo:
        states = copy_video_state(states)
    dets = []
    for t in range(frames.shape[1]):
        states, d = inference_step_batch(
            model, states, frames[:, t], img_shapes, scale_factors, anchors,
            update_memo=update_memo, do_update=t % frame_stride == 0)
        dets.append(d)
    return states, DetResult(*(torch.stack(f, 1) for f in zip(*dets)))


def _one_stream(state: VideoState) -> VideoState:
    """A single-stream state as a batch of one (views, so a roll of the
    batch writes the state's own tensors)."""
    slot = torch.tensor([state.next_slot], dtype=torch.int64,
                        device=state.ref_valid.device)
    maps = state.ref_maps
    return VideoState(tuple((k[None], v[None]) for k, v in state.ref_kv),
                      state.ref_valid[None], slot,
                      None if maps is None else maps[None])


def _batch_of_one(x, like: torch.Tensor) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)[None]


@torch.no_grad()
def stream_head(model: SelsaDetector, state: VideoState, frame: torch.Tensor,
                img_shape, anchors: torch.Tensor,
                impl: Optional[str] = None) -> StreamHead:
    """``stream_head_batch`` for one frame [H, W, 3] against one memo."""
    out = stream_head_batch(model, _one_stream(state), frame[None],
                            _batch_of_one(img_shape, frame), anchors,
                            impl=impl)
    return StreamHead(rpn.Proposals(*(f[0] for f in out.proposals)),
                      out.cls_score[0], out.bbox_pred[0],
                      tuple((k[0], v[0]) for k, v in out.cur_kvs),
                      out.neck[0])


@torch.no_grad()
def inference_step(model: SelsaDetector, state: VideoState,
                   frame: torch.Tensor, img_shape, scale_factor,
                   anchors: torch.Tensor, update_memo: bool = False,
                   do_update: bool = True, impl: Optional[str] = None
                   ) -> Tuple[VideoState, DetResult]:
    """One streamed frame [H, W, 3] -> (state, DetResult): the S = 1 case
    of ``inference_step_batch`` (``impl`` as there).

    With ``update_memo`` (fix-stride mode) and ``do_update``, this frame's
    K/V replace the oldest memo slot, written in place in the given state's
    tensors (see ``roll_memo``); the returned state shares them."""
    states, dets = inference_step_batch(
        model, _one_stream(state), frame[None], _batch_of_one(img_shape, frame),
        _batch_of_one(scale_factor, frame), anchors, update_memo=update_memo,
        do_update=do_update, impl=impl)
    if update_memo and do_update:
        state = VideoState(state.ref_kv, state.ref_valid,
                           (state.next_slot + 1) % state.ref_valid.shape[0],
                           state.ref_maps)
    return state, DetResult(*(f[0] for f in dets))


def inference_clip(model: SelsaDetector, state: VideoState,
                   frames: torch.Tensor, img_shape, scale_factor,
                   anchors: torch.Tensor, update_memo: bool = False,
                   frame_stride: int = 1) -> Tuple[VideoState, DetResult]:
    """Stream frames [T, H, W, 3] in order; the fix-stride roll happens on
    frames t with t % frame_stride == 0. Returns the final state and the
    DetResult fields stacked over frames. The given state is left as it is:
    with ``update_memo`` the memo is copied once per clip."""
    if update_memo:
        state = copy_video_state(state)
    dets = []
    for t in range(frames.shape[0]):
        state, d = inference_step(model, state, frames[t], img_shape,
                                  scale_factor, anchors,
                                  update_memo=update_memo,
                                  do_update=t % frame_stride == 0)
        dets.append(d)
    return state, DetResult(*(torch.stack(f) for f in zip(*dets)))
