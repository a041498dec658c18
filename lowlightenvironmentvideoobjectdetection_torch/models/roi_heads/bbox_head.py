"""Second-stage Shared2FC bbox head with per-FC SELSA aggregation (streaming
form) and its decode, the counterpart of the JAX package's
``models/roi_heads/bbox_head.py`` (``ref_transform_kv``,
``forward_cached_stream_kv``, ``bbox_decode``). The streaming forward and
the decode also take a leading stream axis S (the counterpart of
``jax.vmap`` over them)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import boxes as box_ops, nms as nms_ops
from ..aggregators.selsa_aggregator import Linear, SelsaAggregator

BBOX_STDS = (0.2, 0.2, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    """Shared FCs, each followed by a SELSA aggregator, then cls/reg linears.

    RoI features enter as [N, 7, 7, C]; their row-major flatten is the
    (7, 7, C) row order of the first FC's input, as in the JAX head."""

    fc_out_channels = 1024
    num_attention_blocks = 16
    num_shared_fcs = 2

    def __init__(self, in_features: int, num_classes: int = 30,
                 dtype=torch.float32):
        super().__init__()
        c = self.fc_out_channels
        for i in range(self.num_shared_fcs):
            self.add_module(f"shared_fc{i}", Linear(
                in_features if i == 0 else c, c, dtype=dtype))
            self.add_module(f"aggregator{i}", SelsaAggregator(
                c, self.num_attention_blocks, dtype=dtype))
        self.fc_cls = Linear(c, num_classes + 1, dtype=dtype)
        self.fc_reg = Linear(c, 4 * num_classes, dtype=dtype)

    def _stage(self, i: int):
        return getattr(self, f"shared_fc{i}"), getattr(self, f"aggregator{i}")

    def ref_transform_kv(self, ref_x: torch.Tensor):
        """Per-stage head-major (k, v) [nb, M, hd] of the reference rois: the
        aggregator's projections of each FC's pre-relu activation."""
        ref_x = ref_x.flatten(-3)
        kvs = []
        for i in range(self.num_shared_fcs):
            fc, agg = self._stage(i)
            ref_x = fc(ref_x)
            kvs.append(agg.project_kv_hm(ref_x))
            ref_x = F.relu(ref_x)
        return tuple(kvs)

    def forward_cached_stream_kv(self, x, ref_kvs, ref_mask, self_mask,
                                 impl: Optional[str] = None):
        """Streaming forward over the memo K/V plus this frame's own rois.
        x: [N, 7, 7, C]; ref_kvs: per stage (k, v) [nb, M, hd]; masks: [M]
        and [N] bool. Returns ((cls [N, C+1], reg [N, 4C]), cur_kvs
        [nb, N, hd]). With a leading stream axis on every argument
        (x [S, N, 7, 7, C], ...) each FC is one matmul over all S*N rois,
        each stage one attention launch, and cur_kvs are [S, nb, N, hd]."""
        x = x.flatten(-3)
        cur_kvs = []
        r = None
        for i in range(self.num_shared_fcs):
            fc, agg = self._stage(i)
            xf = fc(x)
            cur = xf if i == 0 else fc(r)  # ref-side activation, pre-relu
            r = F.relu(cur)
            ck, cv = agg.project_kv_hm(cur)
            cur_kvs.append((ck, cv))
            q = agg.project_q(xf)
            x = F.relu(xf + agg.attend_cached2(
                q, ref_kvs[i][0], ref_kvs[i][1], ck, cv, ref_mask, self_mask,
                impl=impl))
        return (self.fc_cls(x), self.fc_reg(x)), tuple(cur_kvs)


def bbox_decode(rois, cls_score, bbox_pred, img_shape,
                roi_valid: Optional[torch.Tensor] = None,
                scale_factor: Optional[torch.Tensor] = None,
                nms_pre: Optional[int] = 2048) -> nms_ops.DetResult:
    """Softmax scores, per-class delta decode (stds 0.2) clipped to
    ``img_shape``, division by ``scale_factor`` [4], then fixed-shape
    multiclass NMS (score > 1e-4, IoU 0.5, at most 100; the reference test
    config). Batched: rois [S, N, 4], head outputs [S, N, ...], img_shape
    [S, 2], scale_factor [S, 4], roi_valid [S, N]; one NMS for all S."""
    scores = torch.softmax(cls_score.float(), dim=-1)
    decoded = box_ops.delta2bbox(rois, bbox_pred.float(), stds=BBOX_STDS,
                                 max_shape=img_shape)
    if scale_factor is not None:
        k = decoded.shape[-1] // 4
        sf = torch.as_tensor(scale_factor, dtype=decoded.dtype,
                             device=decoded.device)
        decoded = decoded / sf.repeat((1,) * (sf.ndim - 1) + (k,))[..., None, :]
    return nms_ops.multiclass_nms(decoded, scores, 1e-4, 0.5, 100,
                                  box_valid=roi_valid, pre_top_k=nms_pre)
