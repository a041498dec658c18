"""ReID embedder for DeepSORT, the counterpart of the JAX package's
``models/reid/base_reid.py`` (mmtracking's ``BaseReID``: ResNet-50,
global average pooling, ``LinearReIDHead``): person crops [N, H, W, 3]
-> embeddings [N, 128] for the host's cosine / Mahalanobis association.

The backbone computes in its ``dtype`` (bfloat16 by default, as in JAX);
the pooled feature is rounded to that dtype (JAX's mean of a bfloat16 map)
and the head runs in float32. Module names are the flax names, for the
weight bridge. With ``num_classes > 0`` the head has the identity
classifier (flax ``classifier``) on the embedding, and a call with
``train=True`` returns (embedding, logits), as in JAX; like the JAX
package, the port has no ReID loss.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..aggregators.selsa_aggregator import Linear
from ..backbones.resnet import ResNet


class LinearReIDHead(nn.Module):
    """One fc + ReLU, then the embedding fc (float32), as the JAX head at
    its defaults (``num_fcs=1``); with ``num_classes > 0`` the training
    branch's ``classifier`` fc on the embedding."""

    def __init__(self, in_channels: int = 2048, fc_channels: int = 1024,
                 out_channels: int = 128, num_classes: int = 0):
        super().__init__()
        self.fc0 = Linear(in_channels, fc_channels)
        self.fc_out = Linear(fc_channels, out_channels)
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = Linear(out_channels, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        embed = self.fc_out(F.relu(self.fc0(x)))
        if train and self.num_classes > 0:
            return embed, self.classifier(embed)
        return embed


class BaseReID(nn.Module):
    def __init__(self, depth: int = 50, out_channels: int = 128,
                 dtype=torch.bfloat16, num_classes: int = 0):
        super().__init__()
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(3,),
                               frozen_stages=-1, dtype=dtype)
        self.head = LinearReIDHead(in_channels=2048,
                                   out_channels=out_channels,
                                   num_classes=num_classes)

    def forward(self, crops: torch.Tensor, train: bool = False):
        """crops [N, H, W, 3] normalized -> [N, out_channels] float32 (and
        the [N, num_classes] logits with ``train`` and a classifier)."""
        feat = self.backbone(crops.permute(0, 3, 1, 2))[0]
        pooled = feat.mean(dim=(2, 3), dtype=torch.float32)
        return self.head(pooled.to(feat.dtype).float(), train=train)
