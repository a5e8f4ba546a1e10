"""Grouped-query attention over the paged MX KV cache (port of
``repro.nn.attention``): the ragged engine step only.

Pools are plain dicts of tensors, ``{"k_elems", "k_scales", "v_elems",
"v_scales"}``, laid out as in the reference: elements ``(NP, PS, KVH,
D)`` fp8, ``(NP, PS, KVH, D // 2)`` packed fp4 uint8, or, for a tiered
pool, full-width ``(NP, PS, KVH, D)`` uint8 rows whose formats live in
the engine's per-page ids; scales ``(NP, PS, KVH, D // k)`` uint8.
:func:`apply_ragged` updates them in place; the reference's jitted step
donates the cache instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import QuantConfig
from repro_torch.core import formats as F
from repro_torch.kernels import mx_attention_ragged_fused

from . import linear
from .rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window (None = full causal)
    softcap: Optional[float] = None


def init(gen: torch.Generator, cfg: AttnConfig, quant: QuantConfig,
         device) -> dict:
    h, kvh, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear.init(gen, dm, h * d, quant, device),
            "wk": linear.init(gen, dm, kvh * d, quant, device),
            "wv": linear.init(gen, dm, kvh * d, quant, device),
            "wo": linear.init(gen, h * d, dm, quant, device)}


def _project_decode_qkv(params, x: torch.Tensor, posv: torch.Tensor,
                        cfg: AttnConfig, compute_dtype):
    """QKV projection + RoPE at per-token positions ``posv (B, S)`` for
    ``x (B, S, d_model)``; every op is token-row independent."""
    b, s = x.shape[:2]
    d = cfg.head_dim
    q = linear.apply(params["wq"], x, compute_dtype).reshape(b, s, -1, d)
    k = linear.apply(params["wk"], x, compute_dtype).reshape(b, s, -1, d)
    v = linear.apply(params["wv"], x, compute_dtype).reshape(b, s, -1, d)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    return q, k, v


def init_paged_pool(num_pages: int, page_size: int, cfg: AttnConfig,
                    quant: QuantConfig, device, tiered: bool = False) -> dict:
    """One layer's global KV page pool (no per-sequence dimension).

    Uniform pools store the format's elements (fp4 packs two per byte;
    fp6 rows are D bytes wide, as the reference's ``_cache_arrays`` lays
    them out, and the ragged kernel refuses them). ``tiered=True``
    allocates full-width uint8 rows for any format of the ladder and
    needs an 8-bit hot format, as in the reference.
    """
    if tiered:
        if not (quant.enabled and quant.quantize_kv_cache):
            raise ValueError("tiered KV pools require an MX-quantized cache")
        if F.get_format(quant.fmt).bits != 8:
            raise ValueError(
                "tiered KV pools write new pages in the hot format, which "
                f"must be an fp8; got {quant.fmt!r}")
    elif not (quant.enabled and quant.quantize_kv_cache):
        raise NotImplementedError(
            "wide bf16 page pools are served by the reference's split step, "
            "which is not ported (ROADMAP A8); the ragged step needs an MX "
            "pool")
    fmt = F.get_format(quant.fmt)
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    bs = min(quant.block_size, d)
    ed = d // 2 if fmt.packed and not tiered else d
    dtype = torch.uint8 if tiered else fmt.storage_dtype
    shape = (num_pages, page_size, kvh, ed)
    sshape = (num_pages, page_size, kvh, d // bs)
    return {"k_elems": torch.zeros(shape, dtype=dtype, device=device),
            "k_scales": torch.zeros(sshape, dtype=torch.uint8, device=device),
            "v_elems": torch.zeros(shape, dtype=dtype, device=device),
            "v_scales": torch.zeros(sshape, dtype=torch.uint8, device=device)}


def apply_ragged(params, x: torch.Tensor, pool: dict, page_rows: torch.Tensor,
                 row_start: torch.Tensor, seq_lens: torch.Tensor,
                 cfg: AttnConfig, quant: QuantConfig,
                 compute_dtype=torch.bfloat16, page_fmts=None,
                 mixed_fmts=None) -> torch.Tensor:
    """One ragged engine step: x (R, W, d_model), row_start/seq_lens (R,).

    Every row feeds W token columns at positions ``row_start ..
    row_start + W - 1``, of which ``seq_lens - row_start`` are real. The
    new rows' K/V go into the kernel wide and are quantized into the
    row's pages inside it; padding columns are excluded from the write
    and their outputs ignored. ``pool`` is updated in place. A tiered
    pool passes its per-page format ids ``page_fmts`` (NP,) and the
    candidate formats ``mixed_fmts``.
    """
    r, w, _ = x.shape
    d = cfg.head_dim
    posv = row_start[:, None] + torch.arange(w, dtype=row_start.dtype,
                                             device=x.device)[None]
    q, k, v = _project_decode_qkv(params, x, posv, cfg, compute_dtype)
    kvh = k.shape[2]
    g = q.shape[2] // kvh
    qk = q.reshape(r, w, kvh, g, d).permute(0, 2, 1, 3, 4).contiguous()
    out, _ = mx_attention_ragged_fused(
        qk, k.contiguous(), v.contiguous(), pool["k_elems"], pool["k_scales"],
        pool["v_elems"], pool["v_scales"], page_rows, row_start, seq_lens,
        fmt_name=quant.fmt, block_size=min(quant.block_size, d),
        softcap=cfg.softcap, window=cfg.window, page_fmts=page_fmts,
        mixed_fmts=mixed_fmts)
    out = out.permute(0, 2, 1, 3, 4).reshape(r, w, -1).to(compute_dtype)
    return linear.apply(params["wo"], out, compute_dtype)
