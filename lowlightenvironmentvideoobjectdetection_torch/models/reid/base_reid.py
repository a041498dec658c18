"""ReID embedder for DeepSORT, the counterpart of the JAX package's
``models/reid/base_reid.py`` (mmtracking's ``BaseReID``: ResNet-50,
global average pooling, ``LinearReIDHead``): person crops [N, H, W, 3]
-> embeddings [N, 128] for the host's cosine / Mahalanobis association.

The backbone computes in its ``dtype`` (bfloat16 by default, as in JAX);
the pooled feature is rounded to that dtype (JAX's mean of a bfloat16 map)
and the head runs in float32. Module names are the flax names, for the
weight bridge. The head's training-time classification branch is not
ported (ROADMAP.md Queue 1, ReID training).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..aggregators.selsa_aggregator import Linear
from ..backbones.resnet import ResNet


class LinearReIDHead(nn.Module):
    """One fc + ReLU, then the embedding fc (float32), as the JAX head at
    its defaults (``num_fcs=1``)."""

    def __init__(self, in_channels: int = 2048, fc_channels: int = 1024,
                 out_channels: int = 128):
        super().__init__()
        self.fc0 = Linear(in_channels, fc_channels)
        self.fc_out = Linear(fc_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(F.relu(self.fc0(x)))


class BaseReID(nn.Module):
    def __init__(self, depth: int = 50, out_channels: int = 128,
                 dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(3,),
                               frozen_stages=-1, dtype=dtype)
        self.head = LinearReIDHead(in_channels=2048,
                                   out_channels=out_channels)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """crops [N, H, W, 3] normalized -> [N, out_channels] float32."""
        feat = self.backbone(crops.permute(0, 3, 1, 2))[0]
        pooled = feat.mean(dim=(2, 3), dtype=torch.float32)
        return self.head(pooled.to(feat.dtype).float())
