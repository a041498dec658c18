"""SELSA cross-frame attention aggregator (streaming form), the counterpart
of the JAX package's ``models/aggregators/selsa_aggregator.py``
(``project_q``, ``project_kv_hm``, ``attend_cached2``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_attention import selsa_fused_attention_2slab_hm


class Linear(nn.Linear):
    """``nn.Linear`` computing in a fixed dtype (input and weights cast), as
    flax's ``Dense(dtype=...)`` does."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class SelsaAggregator(nn.Module):
    def __init__(self, in_channels: int = 1024, num_attention_blocks: int = 16,
                 dtype=torch.float32):
        super().__init__()
        c = in_channels
        self.in_channels = c
        self.num_attention_blocks = num_attention_blocks
        self.compute_dtype = dtype
        self.fc_embed = Linear(c, c, dtype=dtype)
        self.ref_fc_embed = Linear(c, c, dtype=dtype)
        self.ref_fc = Linear(c, c, dtype=dtype)
        self.fc = Linear(c, c, dtype=dtype)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        nb = self.num_attention_blocks
        return t.reshape(-1, nb, self.in_channels // nb)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C] -> [N, nb, hd] query embedding."""
        return self._split(self.fc_embed(x))

    def project_kv_hm(self, ref_x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, C] -> head-major (k, v), each [nb, M, hd] and contiguous."""
        k = self._split(self.ref_fc_embed(ref_x)).transpose(0, 1).contiguous()
        v = self._split(self.ref_fc(ref_x)).transpose(0, 1).contiguous()
        return k, v

    def attend_cached2(self, q, k_memo, v_memo, k_cur, v_cur, memo_mask,
                       cur_mask, impl: Optional[str] = None) -> torch.Tensor:
        """Joint softmax over the memo K/V [nb, M1, hd] and this frame's K/V
        [nb, M2, hd] (cast to the memo dtype); kernel A on CUDA tensors."""
        b1 = torch.where(memo_mask, 0.0, -1e30).float()
        b2 = torch.where(cur_mask, 0.0, -1e30).float()
        agg = selsa_fused_attention_2slab_hm(
            q, k_memo, v_memo, k_cur.to(k_memo.dtype), v_cur.to(v_memo.dtype),
            b1, b2, impl=impl)
        return self.fc(agg.to(self.compute_dtype).reshape(-1, self.in_channels))
