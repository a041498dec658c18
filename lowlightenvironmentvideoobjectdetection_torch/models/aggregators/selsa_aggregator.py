"""SELSA cross-frame attention aggregator, the counterpart of the JAX
package's ``models/aggregators/selsa_aggregator.py``: the joint form
(``forward``, training: plain matmul and softmax attention from the key
rois to the reference rois) and the streaming form (``project_q``,
``project_kv_hm``, ``attend_cached``, ``attend_cached2``).

Every streaming method also takes a leading stream axis S (the counterpart
of ``jax.vmap`` over it): projections keep the leading axes, and the
attention runs all S streams in one kernel launch."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_attention import (
    selsa_fused_attention_2slab_hm,
    selsa_fused_attention_hm,
)


class Linear(nn.Linear):
    """``nn.Linear`` computing in a fixed dtype (input and weights cast), as
    flax's ``Dense(dtype=...)`` does."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def _bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, -1e30).float()


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
        return t.reshape(*t.shape[:-1], nb, self.in_channels // nb)

    def forward(self, x: torch.Tensor, ref_x: torch.Tensor,
                ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Joint attention, x [N, C] over ref_x [M, C] with ref_mask [M]
        (True = a real roi): 16-head scaled dot products, masked keys at
        -1e30, softmax over the M keys, then the output FC. Returns [N, C]
        for the caller's residual add."""
        hd = self.in_channels // self.num_attention_blocks
        q = self._split(self.fc_embed(x)).transpose(0, 1)  # [nb, N, hd]
        k = self._split(self.ref_fc_embed(ref_x)).permute(1, 2, 0)
        w = torch.matmul(q, k) / hd ** 0.5  # [nb, N, M]
        if ref_mask is not None:
            w = torch.where(ref_mask, w, -1e30)
        w = torch.softmax(w, dim=-1)
        v = self._split(self.ref_fc(ref_x)).transpose(0, 1)  # [nb, M, hd]
        agg = torch.matmul(w, v).transpose(0, 1)  # [N, nb, hd]
        return self.fc(agg.reshape(-1, self.in_channels))

    def _merge(self, agg: torch.Tensor) -> torch.Tensor:
        """[..., N, nb, hd] attention output -> fc([..., N, C])."""
        agg = agg.to(self.compute_dtype)
        return self.fc(agg.reshape(*agg.shape[:-2], self.in_channels))

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        """[..., N, C] -> [..., N, nb, hd] query embedding."""
        return self._split(self.fc_embed(x))

    def project_kv_hm(self, ref_x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., M, C] -> head-major (k, v), each [..., nb, M, hd] and
        contiguous."""
        k = self._split(self.ref_fc_embed(ref_x)).transpose(-3, -2)
        v = self._split(self.ref_fc(ref_x)).transpose(-3, -2)
        return k.contiguous(), v.contiguous()

    def attend_cached(self, q, k, v, ref_mask: Optional[torch.Tensor] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
        """Attention over one head-major K/V slab [..., nb, M, hd] (the
        memo layout); ref_mask [..., M] (None: every key live). Kernel C on
        CUDA tensors."""
        bias = (_bias(ref_mask) if ref_mask is not None
                else torch.zeros(k.shape[:-3] + k.shape[-2:-1],
                                 dtype=torch.float32, device=k.device))
        return self._merge(selsa_fused_attention_hm(q, k, v, bias, impl=impl))

    def attend_cached2(self, q, k_memo, v_memo, k_cur, v_cur, memo_mask,
                       cur_mask, impl: Optional[str] = None) -> torch.Tensor:
        """Joint softmax over the memo K/V [..., nb, M1, hd] and this frame's
        K/V [..., nb, M2, hd] (cast to the memo dtype); kernel A on CUDA
        tensors. Same math as ``attend_cached`` over the concatenation."""
        agg = selsa_fused_attention_2slab_hm(
            q, k_memo, v_memo, k_cur.to(k_memo.dtype), v_cur.to(v_memo.dtype),
            _bias(memo_mask), _bias(cur_mask), impl=impl)
        return self._merge(agg)
