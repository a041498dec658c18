"""TemporalRoIAlign, the counterpart of the JAX package's
``models/roi_heads/temporal_roi_align.py``: the most-similar RoI align (each
RoI pixel's cosine similarity with every pixel of each reference map, the
top k, their softmax and a weighted gather of the raw map's pixels), then
multi-head temporal attention over [key, references].

The similarity is one f32 matmul per reference map, [roi_n*49, h*w], built
one map at a time as JAX's ``lax.map`` does (one map's matrix is 143 MB at
300 rois on a 38x64 map; all 14 at once would be 2 GB). TF32 stays off for
it: a TF32 product moves the top-k choices. It is plain torch, as JAX's
einsum is no Pallas kernel. The attention's 3x3 embed conv runs in the
compute dtype, everything else in f32, as in JAX.

Every method also takes a leading stream axis S (the counterpart of
``jax.vmap``): roi features [S, N, 7, 7, C] against each stream's own maps
[S, R, h, w, C], with one embed conv for all streams.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from ..backbones.resnet import Conv2d


@contextlib.contextmanager
def _no_tf32():
    """f32 matmuls in full precision inside, whatever the caller set."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = before


def top_k(x: torch.Tensor, k: int):
    """The k largest of each row of x [Q, M] and their indices, in
    descending order, ties to the lower index as ``lax.top_k`` breaks them
    (an all-zero RoI pixel ties every map pixel): k passes of ``argmax``,
    which returns the first of equal maxima."""
    rest = x.detach()
    idx = []
    for i in range(k):
        idx.append(rest.argmax(1, keepdim=True))
        if i + 1 < k:
            rest = rest.scatter(1, idx[-1], float("-inf"))
    idx = torch.cat(idx, 1)
    return x.gather(1, idx), idx


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-6)


class TemporalRoIAlign(nn.Module):
    def __init__(self, out_channels: int = 512,
                 num_most_similar_points: int = 2,
                 num_temporal_attention_blocks: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.num_most_similar_points = num_most_similar_points
        self.num_temporal_attention_blocks = num_temporal_attention_blocks
        if num_temporal_attention_blocks > 0:
            # named as the flax module, for the weight bridge
            self.embed_network = Conv2d(out_channels, out_channels, 3,
                                        padding=1, dtype=dtype)

    def most_similar_roi_align(self, roi_feats: torch.Tensor,
                               ref_feats: torch.Tensor) -> torch.Tensor:
        """roi_feats [N, 7, 7, C], ref_feats [R, h, w, C], both f32 ->
        [R, N, 7, 7, C]: per reference map, each RoI pixel's softmax over its
        k most similar map pixels, weighting those pixels."""
        n, rh, rw, c = roi_feats.shape
        q = _l2_normalize(roi_feats).reshape(-1, c)
        out = []
        for ref in ref_feats:
            flat = ref.reshape(-1, c)
            with _no_tf32():
                sim = q @ _l2_normalize(flat).T  # [N*49, h*w]
            vals, idx = top_k(sim, self.num_most_similar_points)
            weights = vals.softmax(-1)
            out.append((flat[idx] * weights[..., None]).sum(1))
        return torch.stack(out).reshape(-1, n, rh, rw, c)

    def forward(self, roi_feats: torch.Tensor,
                ref_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """roi_feats [N, 7, 7, C] (from the plain RoIAlign) against the
        reference maps ref_feats [R, h, w, C], or with a stream axis
        [S, N, 7, 7, C] against [S, R, h, w, C]. Returns f32 features of
        roi_feats' shape; ``ref_feats`` None returns roi_feats as they
        are."""
        if ref_feats is None:
            return roi_feats
        lead = roi_feats.shape[:-3]
        rois = roi_feats.float().reshape(-1, *roi_feats.shape[-3:])
        if ref_feats.ndim == 5:  # per stream, against its own maps
            ref_roi = torch.cat(
                [self.most_similar_roi_align(r.float(), m.float())
                 for r, m in zip(roi_feats, ref_feats)], 1)
        else:
            ref_roi = self.most_similar_roi_align(rois, ref_feats.float())
        x = torch.cat([rois[None], ref_roi])  # [1+R, N, 7, 7, C]
        nb = self.num_temporal_attention_blocks
        if nb == 0:
            return x.mean(0).reshape(roi_feats.shape)
        img_n, roi_n, rh, rw, c = x.shape
        embed = self.embed_network(
            x.reshape(-1, rh, rw, c).permute(0, 3, 1, 2))
        embed = embed.permute(0, 2, 3, 1).reshape(img_n, roi_n, rh, rw, nb,
                                                  c // nb)
        ada = (embed * embed[:1]).sum(-1, keepdim=True) / (c / nb) ** 0.5
        ada = ada.expand(embed.shape).reshape(x.shape).softmax(0)
        return (x * ada).sum(0).reshape(*lead, rh, rw, c)
