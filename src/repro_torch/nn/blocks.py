"""Decoder block wiring (port of ``repro.nn.blocks``), attention only.

Pre-norm residual blocks: attention then a dense gated FFN. MoE, MLA and
recurrent mixers (ROADMAP A12) and gemma2's post-norms (A3) raise here.
"""
from __future__ import annotations

import torch

from . import attention, ffn
from .config import BlockDef, ModelConfig
from .norms import rmsnorm_apply, rmsnorm_init


def _attn_cfg(cfg: ModelConfig, bd: BlockDef) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=bd.window,
        softcap=cfg.attn_softcap, decode_kernel=cfg.decode_kernel)


def _require_ported(bd: BlockDef, cfg: ModelConfig) -> None:
    if bd.mixer != "attn":
        raise NotImplementedError(
            f"mixer {bd.mixer!r} is not ported to repro_torch (ROADMAP A12)")
    if bd.ffn != "dense" or cfg.ffn_kind != "swiglu":
        raise NotImplementedError(
            f"ffn {bd.ffn!r}/{cfg.ffn_kind!r} is not ported (ROADMAP A3, "
            "A12)")


def init(gen: torch.Generator, bd: BlockDef, cfg: ModelConfig,
         device) -> dict:
    _require_ported(bd, cfg)
    return {"norm_mixer": rmsnorm_init(cfg.d_model, device),
            "mixer": attention.init(gen, _attn_cfg(cfg, bd), cfg.quant,
                                    device),
            "norm_ffn": rmsnorm_init(cfg.d_model, device),
            "ffn": ffn.init(gen, cfg.d_model, cfg.d_ff, cfg.quant, device)}


def _decode_tail(params, x: torch.Tensor, h: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Residual add + channel mixer.

    The reference's jitted step fuses the residual add into the RMSNorm
    that follows it, and XLA's excess-precision rule then hands the norm
    the unrounded f32 sum, while the residual stream itself is stored
    rounded to bf16. The port computes the same two values.
    """
    dt = cfg.compute_dtype
    x_sum = x.to(torch.float32) + h.to(torch.float32)
    h = rmsnorm_apply(params["norm_ffn"], x_sum, cfg.norm_eps, dtype=dt)
    h = ffn.apply(params["ffn"], h, dt)
    return x_sum.to(dt) + h


def init_paged_cache(num_pages: int, page_size: int, bd: BlockDef,
                     cfg: ModelConfig, device, tiered: bool = False) -> dict:
    _require_ported(bd, cfg)
    return attention.init_paged_pool(num_pages, page_size,
                                     _attn_cfg(cfg, bd), cfg.quant, device,
                                     tiered=tiered)


def apply_ragged_step(params, x: torch.Tensor, cache: dict,
                      page_rows: torch.Tensor, row_start: torch.Tensor,
                      seq_lens: torch.Tensor, bd: BlockDef,
                      cfg: ModelConfig, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """One ragged engine step of one block: x (R, W, d_model); the
    block's page pool ``cache`` is updated in place (a tiered pool with
    its ``page_fmts`` / ``mixed_fmts``)."""
    _require_ported(bd, cfg)
    h = rmsnorm_apply(params["norm_mixer"], x, cfg.norm_eps)
    h = attention.apply_ragged(params["mixer"], h, cache, page_rows,
                               row_start, seq_lens, _attn_cfg(cfg, bd),
                               cfg.quant, cfg.compute_dtype,
                               page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    return _decode_tail(params, x, h, cfg)


def apply_verify_paged(params, x: torch.Tensor, cache: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       bd: BlockDef, cfg: ModelConfig, page_fmts=None,
                       mixed_fmts=None) -> torch.Tensor:
    """Multi-token paged verify of one block: x (B, Tq, d_model), pos (B,)
    each slot's first position; ``cache`` is updated in place."""
    _require_ported(bd, cfg)
    h = rmsnorm_apply(params["norm_mixer"], x, cfg.norm_eps)
    h = attention.apply_verify_paged(params["mixer"], h, cache, page_rows,
                                     pos, _attn_cfg(cfg, bd), cfg.quant,
                                     cfg.compute_dtype, page_fmts=page_fmts,
                                     mixed_fmts=mixed_fmts)
    return _decode_tail(params, x, h, cfg)


def apply_decode_paged(params, x: torch.Tensor, cache: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       bd: BlockDef, cfg: ModelConfig, page_fmts=None,
                       mixed_fmts=None) -> torch.Tensor:
    """Per-slot decode of one block: x (B, 1, d_model), pos (B,)."""
    return apply_verify_paged(params, x, cache, page_rows, pos, bd, cfg,
                              page_fmts=page_fmts, mixed_fmts=mixed_fmts)


def apply_prefill_chunked(params, x: torch.Tensor, cache: dict,
                          page_rows: torch.Tensor, pos: torch.Tensor,
                          num_valid: torch.Tensor, bd: BlockDef,
                          cfg: ModelConfig, page_fmts=None,
                          mixed_fmts=None) -> torch.Tensor:
    """One chunk of paged prefill of one block: x (B, C, d_model), pos
    (B,) chunk starts, num_valid (B,) real tokens in the chunk."""
    _require_ported(bd, cfg)
    h = rmsnorm_apply(params["norm_mixer"], x, cfg.norm_eps)
    h = attention.apply_prefill_chunked(
        params["mixer"], h, cache, page_rows, pos, num_valid,
        _attn_cfg(cfg, bd), cfg.quant, cfg.compute_dtype,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    return _decode_tail(params, x, h, cfg)
