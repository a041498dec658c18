"""RPN head and static-shape proposal generation, the counterpart of the JAX
package's ``models/dense_heads/rpn_head.py`` (``RPNHead``, ``Proposals``,
``rpn_proposals``) at one level (the DC5 detectors have one)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import boxes as box_ops, nms as nms_ops
from ..backbones.resnet import Conv2d


class RPNHead(nn.Module):
    """3x3 conv + relu, 1x1 cls (one logit per anchor), 1x1 reg (4 per
    anchor)."""

    def __init__(self, in_channels: int = 512, feat_channels: int = 512,
                 num_base_anchors: int = 12, dtype=torch.float32):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               dtype=dtype)
        self.rpn_cls = Conv2d(feat_channels, num_base_anchors, 1, dtype=dtype)
        self.rpn_reg = Conv2d(feat_channels, num_base_anchors * 4, 1,
                              dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x: NHWC [T, H, W, C]. Returns (cls [T, H, W, A],
        reg [T, H, W, 4A]), NHWC like the JAX head, so a flatten gives the
        JAX anchor order (y, x, a)."""
        h = F.relu(self.rpn_conv(x.permute(0, 3, 1, 2)))
        return (self.rpn_cls(h).permute(0, 2, 3, 1),
                self.rpn_reg(h).permute(0, 2, 3, 1))


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [num, 4]
    scores: torch.Tensor  # [num]
    valid: torch.Tensor  # [num] bool


def rpn_proposals(cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
                  img_shape, nms_pre: int = 6000, nms_post: int = 600,
                  iou_threshold: float = 0.7) -> Proposals:
    """Fixed-count proposals for one image from its RPN outputs
    (cls [H, W, A], reg [H, W, 4A]): decode every anchor, clip to
    ``img_shape`` (h, w), then one NMS over the top ``nms_pre``."""
    scores = torch.sigmoid(cls.reshape(-1).float())
    boxes = box_ops.delta2bbox(anchors, reg.reshape(-1, 4).float(),
                               max_shape=img_shape)
    res = nms_ops.nms_fixed(boxes, scores, iou_threshold, nms_post,
                            pre_top_k=nms_pre)
    return Proposals(res.boxes, res.scores, res.valid)
