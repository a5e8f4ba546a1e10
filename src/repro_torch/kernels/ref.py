"""PyTorch oracles of the MX kernels' semantics (port of
``repro.kernels.ref``).

They implement the paper's Eq. (1)/(2) literally: per MX block an f32 dot
product of decoded elements, times the two E8M0 block scales, summed over
blocks. The kernels and their plain versions are tested against them.
They build (M, N, K/k) intermediates: for test sizes only.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core import host_math


def decode_scaled(elems, scales, fmt, block_size: int):
    """Decode (..., K)-stored MX data to blocked f32 ``(..., KB, k)`` plus
    the f32 block factors ``(..., KB)`` (byte 0 reads as zero, see
    ``formats.e8m0_factor``)."""
    vals = F.decode_elements(elems, fmt)
    kb = scales.shape[-1]
    blocked = vals.reshape(*vals.shape[:-1], kb, block_size)
    return blocked, F.e8m0_factor(scales)


def mx_matmul_ref(a_elems, a_scales, b_elems, b_scales, *, fmt="fp8_e4m3",
                  block_size: int = 32, acc_dtype=torch.float32):
    """MX x MX oracle: ``C[m, n] = sum_b sA[m,b] sB[n,b] <A[m,b,:], B[n,b,:]>``
    for A stored (M, K) and B stored (N, K) ("column-major B")."""
    a, sa = decode_scaled(a_elems, a_scales, fmt, block_size)
    b, sb = decode_scaled(b_elems, b_scales, fmt, block_size)
    partial = torch.einsum("mbk,nbk->mnb", a, b)
    return (partial * sa[:, None, :] * sb[None, :, :]).sum(-1).to(acc_dtype)


def mx_matmul_wo_ref(a, b_elems, b_scales, *, fmt="fp8_e4m3",
                     block_size: int = 32, acc_dtype=torch.float32):
    """Weight-only oracle (vector-scalar variant): wide A x MX B."""
    b, sb = decode_scaled(b_elems, b_scales, fmt, block_size)
    kb = sb.shape[-1]
    a = a.to(torch.float32).reshape(*a.shape[:-1], kb, block_size)
    partial = torch.einsum("mbk,nbk->mnb", a, b)
    return (partial * sb[None, :, :]).sum(-1).to(acc_dtype)


def mx_quantize_ref(x, *, fmt="fp8_e4m3", block_size: int = 32):
    """Block-quantization oracle: ``(elements storage, e8m0 scales)``.

    The reference's ``where(scale > 0, ...)`` runs with subnormals
    flushed, so E8M0 byte 0 (2^-127) counts as a zero scale and subnormal
    inputs as signed zeros; both are written out here.
    """
    fmt_i = F.get_format(fmt)
    x = F.flush_subnormals(x.to(torch.float32))
    k = x.shape[-1]
    blocked = x.reshape(*x.shape[:-1], k // block_size, block_size)
    e = F.e8m0_from_amax(blocked.abs().amax(dim=-1), fmt_i)
    scale = F.e8m0_to_scale(e)[..., None]
    ratio = torch.where(e[..., None] > 0, blocked / scale,
                        torch.zeros_like(blocked)).reshape(x.shape)
    return F.encode_elements(ratio, fmt_i), e


def mx_attention_decode_ref(q, k_elems, k_scales, v_elems, v_scales, kpos,
                            pos, *, fmt="fp8_e4m3", block_size: int = 32,
                            softcap=None):
    """Oracle of the MX-KV-cache decode attention kernel.

    q (B, KVH, G, D); cache (B, KVH, T, storage) elements + (B, KVH, T,
    D//k) E8M0 scales; ``kpos`` (T,), ``pos`` a scalar. Dequantize, mask
    ``(kpos <= pos) & (kpos >= 0)`` to -2e38, softmax, einsum. Returns
    (B, KVH, G, D) f32.
    """
    def deq(elems, scales):
        blocked, factor = decode_scaled(elems, scales, fmt, block_size)
        return (blocked * factor[..., None]).reshape(
            *blocked.shape[:-2], -1)

    k = deq(k_elems, k_scales)  # (B, KVH, T, D)
    v = deq(v_elems, v_scales)
    d = q.shape[-1]
    logits = torch.einsum("bhgd,bhtd->bhgt", q.to(torch.float32), k) \
        * d ** -0.5
    if softcap:
        logits = host_math.softcap(logits, softcap)
    kpos = torch.as_tensor(kpos, device=q.device)
    mask = (kpos <= pos) & (kpos >= 0)
    logits = torch.where(mask[None, None, None, :], logits,
                         torch.full_like(logits, -2.0e38))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", p, v)
