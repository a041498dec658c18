"""SELSA attention: the plain torch versions and the CUDA kernel
``csrc/selsa_attention.cu`` behind one entry per form.

Counterpart of the JAX package's ``ops/fused_attention.py``
(``selsa_attention_reference_hm``, the roi-major ``selsa_fused_attention``
and the TPU kernels ``selsa_fused_attention_hm``, kernel C, and
``selsa_fused_attention_2slab_hm``, kernel A), with its public
layouts: q [N, nb, hd], k/v [nb, M, hd], bias [M] f32 (0 live, -1e30
masked), output [N, nb, hd] f32. Every head-major form also takes a leading
stream axis S on all its operands (q [S, N, nb, hd], k/v [S, nb, M, hd],
bias [S, M]), the counterpart of ``jax.vmap`` over it; the kernel then runs
all S streams in one launch. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

The kernel has two bodies (``_attention_body``): ``mma`` on the tensor cores
for bf16 q and K/V (the default config's path) and ``fma`` on the CUDA cores
for f32 and mixed dtypes. Each entry counts its launches in ``launches`` and
per body in ``body_launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = {"fma": 0, "mma": 1}


def _attention_body(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The kernel body for a dtype pair: ``"mma"`` (bf16 tensor-core
    products, f32 softmax, P split in two bf16 parts) for bf16 q and K/V,
    ``"fma"`` (f32 arithmetic on the CUDA cores) for every other pair."""
    return "mma" if q_dtype == kv_dtype == torch.bfloat16 else "fma"


def selsa_attention_reference_hm(q, k, v, bias):
    """Plain attention over one head-major slab, in f32."""
    hd = q.shape[-1]
    s = torch.einsum("...nbc,...bmc->...bnm", q.float(), k.float()) / (hd ** 0.5)
    s = s + bias.float()[..., None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...bnm,...bmc->...nbc", p, v.float())


def _check_impl(impl):
    if impl not in (None, "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "plain"


def selsa_fused_attention_hm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Kernel C: softmax attention over one head-major K/V slab. Returns
    [N, nb, hd] (or [S, N, nb, hd]) f32.

    ``impl="plain"`` forces the plain version (for comparisons only)."""
    if _check_impl(impl) or q.device.type == "cpu":
        return selsa_attention_reference_hm(q, k, v, bias)
    return _attention_cuda("llvod_selsa_attention_1slab",
                           selsa_fused_attention_hm, q, ((k, v, bias),))


def selsa_fused_attention(q, k, v, bias, impl: Optional[str] = None):
    """Roi-major wrapper of kernel C: q [N, nb, hd]; k, v [M, nb, hd]."""
    return selsa_fused_attention_hm(
        q, k.transpose(-3, -2).contiguous(), v.transpose(-3, -2).contiguous(),
        bias, impl=impl)


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
    """Kernel A: softmax over ``concat([k_memo, k_cur], -2)`` without
    building the concatenation (on the card). Returns [N, nb, hd] (or
    [S, N, nb, hd]) f32.

    ``impl="plain"`` forces the plain version (for comparisons only)."""
    if _check_impl(impl) or q.device.type == "cpu":
        k = torch.cat([k_memo, k_cur.to(k_memo.dtype)], dim=-2)
        v = torch.cat([v_memo, v_cur.to(v_memo.dtype)], dim=-2)
        return selsa_attention_reference_hm(
            q, k, v, torch.cat([bias_memo.float(), bias_cur.float()], dim=-1))
    return _attention_cuda("llvod_selsa_attention_2slab",
                           selsa_fused_attention_2slab_hm, q,
                           ((k_memo, v_memo, bias_memo),
                            (k_cur, v_cur, bias_cur)))


def _attention_cuda(entry, counted, q, slabs):
    """Check the operands, launch ``entry`` over all streams, count it on
    ``counted``. ``slabs``: ((k, v, bias), ...) in key order."""
    if q.device.type != "cuda":
        raise RuntimeError(f"selsa attention: no kernel for device {q.device}")
    if q.ndim not in (3, 4):
        raise ValueError(f"selsa attention: q has shape {tuple(q.shape)}")
    lead = tuple(q.shape[:-3])  # () or (S,)
    n, nb, hd = q.shape[-3:]
    if hd != 64:
        raise ValueError(f"selsa attention kernel: head dim {hd} != 64")
    lengths = [k.shape[-2] for k, _, _ in slabs]
    ts = [q]
    for i, ((k, v, b), m) in enumerate(zip(slabs, lengths)):
        for name, t, shape in ((f"k{i}", k, (nb, m, hd)),
                               (f"v{i}", v, (nb, m, hd)), (f"bias{i}", b, (m,))):
            if tuple(t.shape) != lead + shape:
                raise ValueError(f"selsa attention: {name} {tuple(t.shape)} "
                                 f"!= {lead + shape}")
            if t.device != q.device:
                raise ValueError(f"selsa attention: {name} on {t.device}")
        if b.dtype != torch.float32:
            raise TypeError("selsa attention kernel: biases must be float32")
        ts += [k, v]
    ts += [b for _, _, b in slabs]
    if sum(lengths) == 0:
        raise ValueError("selsa attention: no keys")
    kv_dtype = slabs[0][0].dtype
    if q.dtype not in _DTYPES or kv_dtype not in _DTYPES:
        raise TypeError(f"selsa attention: dtypes {q.dtype}, {kv_dtype}")
    if any(t.dtype != kv_dtype for k, v, _ in slabs for t in (k, v)):
        raise TypeError("selsa attention kernel: K/V slabs need one dtype")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selsa attention kernel: inputs must be contiguous")
    body = _attention_body(q.dtype, kv_dtype)
    if body == "mma" and any(t.data_ptr() % 16 for k, v, _ in slabs
                             for t in (k, v)):
        raise ValueError("selsa attention kernel: bf16 K/V must start on a "
                         "16-byte boundary")
    out = torch.empty(lead + (n, nb, hd), dtype=torch.float32, device=q.device)
    s = lead[0] if lead else 1
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = getattr(lib, entry)(
        *(t.data_ptr() for t in ts), out.data_ptr(), s, n, nb, *lengths,
        _DTYPES[q.dtype], _DTYPES[kv_dtype], _BODIES[body], stream)
    cuda_build.check(status, entry)
    counted.launches += 1
    counted.body_launches[body] += 1
    return out


selsa_fused_attention_hm.launches = 0
selsa_fused_attention_hm.body_launches = dict.fromkeys(_BODIES, 0)
selsa_fused_attention_2slab_hm.launches = 0
selsa_fused_attention_2slab_hm.body_launches = dict.fromkeys(_BODIES, 0)
