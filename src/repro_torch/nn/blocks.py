"""Decoder block wiring (port of ``repro.nn.blocks``), attention only.

Pre-norm residual blocks: attention then a dense gated FFN. MoE, MLA and
recurrent mixers (ROADMAP A8) and gemma2's post-norms (A6) raise here.
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
            f"mixer {bd.mixer!r} is not ported to repro_torch (ROADMAP A8)")
    if bd.ffn != "dense" or cfg.ffn_kind != "swiglu":
        raise NotImplementedError(
            f"ffn {bd.ffn!r}/{cfg.ffn_kind!r} is not ported (ROADMAP A6, "
            "A8)")


def init(gen: torch.Generator, bd: BlockDef, cfg: ModelConfig,
         device) -> dict:
    _require_ported(bd, cfg)
    return {"norm_mixer": rmsnorm_init(cfg.d_model, device),
            "mixer": attention.init(gen, _attn_cfg(cfg, bd), cfg.quant,
                                    device),
            "norm_ffn": rmsnorm_init(cfg.d_model, device),
            "ffn": ffn.init(gen, cfg.d_model, cfg.d_ff, cfg.quant, device)}


def _decode_tail(params, x: torch.Tensor, h: torch.Tensor, norm_eps: float,
                 dt: torch.dtype) -> torch.Tensor:
    """Residual add + channel mixer.

    The reference's jitted step fuses the residual add into the RMSNorm
    that follows it, and XLA's excess-precision rule then hands the norm
    the unrounded f32 sum, while the residual stream itself is stored
    rounded to bf16. The port computes the same two values.
    """
    x_sum = x.to(torch.float32) + h.to(torch.float32)
    h = rmsnorm_apply(params["norm_ffn"], x_sum, norm_eps, dtype=dt)
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
    return _decode_tail(params, x, h, cfg.norm_eps, cfg.compute_dtype)


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
    return _decode_tail(params, x, h, cfg.norm_eps, cfg.compute_dtype)


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
    return _decode_tail(params, x, h, cfg.norm_eps, cfg.compute_dtype)


def megakernel_reject_reason(cfg: ModelConfig):
    """Why the layer-fused megakernel cannot serve ``cfg`` (None: it can).

    The reference's static rungs of the serve engine's ladder for
    ``step_mode="megakernel"``, string for string, for every rung this
    package's ``ModelConfig`` can express (it has no sandwich post-norms;
    the engine adds the runtime rungs). Each string names why the engine
    falls back to the per-layer ragged step.
    """
    all_blocks = cfg.all_blocks()
    if not all_blocks:
        return "empty layer stack"
    if any(bd.mixer != "attn" for bd in all_blocks):
        mixers = sorted({bd.mixer for bd in all_blocks if bd.mixer != "attn"})
        return f"non-attention mixers {mixers} (MoE/recurrent hybrids)"
    if any(bd != all_blocks[0] for bd in all_blocks):
        return ("non-uniform block pattern (per-layer windows or channel "
                "mixers need per-layer kernel specialization)")
    if cfg.prologue or cfg.epilogue or len(cfg.pattern) != 1:
        return ("non-trivial stack layout (prologue/epilogue blocks or a "
                "multi-block pattern break the stacked-cache coincidence "
                "with the per-layer scan)")
    if all_blocks[0].ffn != "dense":
        return (f"ffn kind {all_blocks[0].ffn!r} (the fused layer tail "
                "implements the dense gated MLP only)")
    if cfg.quant.enabled and cfg.quant.quantize_acts:
        return ("activation quantization (qat_matmul's custom-vjp pallas "
                "path cannot nest inside the megakernel)")
    if not (cfg.quant.enabled and cfg.quant.quantize_kv_cache):
        return "wide bf16 KV pool (no MX page walk to fuse over)"
    return None
