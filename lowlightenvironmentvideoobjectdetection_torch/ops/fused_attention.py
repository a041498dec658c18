"""Two-slab SELSA attention: the plain torch version and the CUDA kernel
``csrc/selsa_attention.cu`` behind one entry.

Counterpart of the JAX package's ``ops/fused_attention.py``
(``selsa_attention_reference_hm`` and the TPU kernel
``selsa_fused_attention_2slab_hm``), with its public layouts: q
[N, nb, hd], k/v [nb, M, hd], bias [M] f32 (0 live, -1e30 masked), output
[N, nb, hd] f32. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selsa_attention_reference_hm(q, k, v, bias):
    """Plain attention over one head-major slab, in f32."""
    hd = q.shape[-1]
    s = torch.einsum("nbc,bmc->bnm", q.float(), k.float()) / (hd ** 0.5)
    s = s + bias.float()[None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnm,bmc->nbc", p, v.float())


def selsa_fused_attention_2slab_hm(
    q: torch.Tensor,
    k_memo: torch.Tensor,
    v_memo: torch.Tensor,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    bias_memo: torch.Tensor,
    bias_cur: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """softmax over ``concat([k_memo, k_cur], 1)`` without building the
    concatenation (on the card). Returns [N, nb, hd] f32.

    ``impl="plain"`` forces the plain version (for comparisons only)."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        k = torch.cat([k_memo, k_cur.to(k_memo.dtype)], dim=1)
        v = torch.cat([v_memo, v_cur.to(v_memo.dtype)], dim=1)
        return selsa_attention_reference_hm(
            q, k, v, torch.cat([bias_memo.float(), bias_cur.float()]))
    return _attention_cuda(q, k_memo, v_memo, k_cur, v_cur, bias_memo,
                           bias_cur)


def _attention_cuda(q, k1, v1, k2, v2, b1, b2):
    if q.device.type != "cuda":
        raise RuntimeError(f"selsa attention: no kernel for device {q.device}")
    n, nb, hd = q.shape
    if hd != 64:
        raise ValueError(f"selsa attention kernel: head dim {hd} != 64")
    m1, m2 = k1.shape[1], k2.shape[1]
    expect = {"k_memo": (k1, (nb, m1, hd)), "v_memo": (v1, (nb, m1, hd)),
              "k_cur": (k2, (nb, m2, hd)), "v_cur": (v2, (nb, m2, hd)),
              "bias_memo": (b1, (m1,)), "bias_cur": (b2, (m2,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selsa attention: {name} {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != q.device:
            raise ValueError(f"selsa attention: {name} on {t.device}")
    if m1 + m2 == 0:
        raise ValueError("selsa attention: no keys")
    if q.dtype not in _DTYPES or k1.dtype not in _DTYPES:
        raise TypeError(f"selsa attention: dtypes {q.dtype}, {k1.dtype}")
    if not (k1.dtype == v1.dtype == k2.dtype == v2.dtype):
        raise TypeError("selsa attention kernel: K/V slabs need one dtype")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError("selsa attention kernel: biases must be float32")
    ts = (q, k1, v1, k2, v2, b1, b2)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selsa attention kernel: inputs must be contiguous")
    out = torch.empty((n, nb, hd), dtype=torch.float32, device=q.device)
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.llvod_selsa_attention_2slab(
        *(t.data_ptr() for t in ts), out.data_ptr(), n, nb, m1, m2,
        _DTYPES[q.dtype], _DTYPES[k1.dtype], stream)
    cuda_build.check(status, "llvod_selsa_attention_2slab")
    selsa_fused_attention_2slab_hm.launches += 1
    return out


selsa_fused_attention_2slab_hm.launches = 0
