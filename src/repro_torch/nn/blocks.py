"""Decoder block wiring (port of ``repro.nn.blocks``): a sequence mixer
(attention, multi-head latent attention, RG-LRU or SSD) and a channel
mixer.

Pre-norm residual blocks: the mixer (``nn.attention``, ``nn.mla``,
``nn.rglru``, ``nn.ssd``) then a channel mixer, a dense FFN (SwiGLU,
GeGLU or musicgen's no-gate GELU), a mixture of experts (``ffn="moe"``,
``nn.moe``) or none (``ffn="none"``, mamba2's mixer-only blocks), with
gemma2's sandwich post-norms where the config asks for them. MLA blocks run the
contiguous-cache paths alone (dense prefill, one-token decode), as in the
reference. The recurrent mixers keep a state instead of a K/V cache: the
contiguous cache holds it per batch row, and the paged cache per decode
slot (``init_paged_cache``), which the split step's decode updates in
place. Every paged path that needs attention (speculative verify, chunked
prefill, the ragged step, the prefix-cached prefill) raises for the other
mixers with the reference's messages.
"""
from __future__ import annotations

import torch

from . import attention, ffn, linear, mla, moe, rglru, ssd
from .config import BlockDef, ModelConfig
from .norms import rmsnorm_apply, rmsnorm_init


def _attn_cfg(cfg: ModelConfig, bd: BlockDef) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=bd.window,
        softcap=cfg.attn_softcap, query_chunk=cfg.query_chunk,
        no_ring=cfg.serve_full_cache, decode_kernel=cfg.decode_kernel)


def _mla_cfg(cfg: ModelConfig) -> mla.MLAConfig:
    return mla.MLAConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads, kv_lora=cfg.kv_lora,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
        query_chunk=cfg.query_chunk)


def _rglru_cfg(cfg: ModelConfig) -> rglru.RGLRUConfig:
    return rglru.RGLRUConfig(d_model=cfg.d_model,
                             width=cfg.rnn_width or cfg.d_model,
                             conv_width=cfg.conv_width)


def _ssd_cfg(cfg: ModelConfig) -> ssd.SSDConfig:
    return ssd.SSDConfig(
        d_model=cfg.d_model, d_inner=cfg.d_inner, headdim=cfg.headdim,
        d_state=cfg.d_state, ngroups=cfg.ngroups, conv_width=cfg.conv_width,
        chunk=cfg.ssd_chunk)


RECURRENT = ("rglru", "ssd")


def _moe_cfg(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model, d_ff_expert=cfg.d_ff_expert,
        num_experts=cfg.num_experts, top_k=cfg.top_k,
        num_shared=cfg.num_shared,
        d_ff_shared=cfg.num_shared * cfg.d_ff_expert,
        ffn_kind=cfg.ffn_kind, aux_loss_weight=cfg.aux_loss_weight,
        dispatch=cfg.moe_dispatch)


def _require_ported(bd: BlockDef, cfg: ModelConfig) -> None:
    if bd.mixer not in ("attn", "mla", *RECURRENT):
        raise ValueError(bd.mixer)
    if bd.ffn not in ("dense", "moe", "none"):
        raise ValueError(f"unknown channel mixer {bd.ffn!r}")
    if bd.ffn != "none" and cfg.ffn_kind not in ffn.ACTIVATIONS:
        raise ValueError(f"unknown ffn kind {cfg.ffn_kind!r} (expected one "
                         f"of {sorted(ffn.ACTIVATIONS)})")


#: why each paged path takes attention mixers alone, as the reference
#: says it (MLA is served through the contiguous cache)
_ATTN_ONLY = {
    "speculative verify": "recurrent state cannot be rolled back "
    "page-exactly — it has no position axis to truncate",
    "chunked paged prefill": "recurrent state is per-slot, not paged — "
    "chunk-at-a-time prefill has no pages to resume from",
    "the ragged engine step": "the engine falls back to "
    "step_mode='split'",
    "prefix-cached prefill": "recurrent state would need per-node "
    "snapshots",
}


def _require_attn(bd: BlockDef, cfg: ModelConfig, what: str) -> None:
    """The paged paths that take attention mixers alone raise for the
    others with the reference's message."""
    _require_ported(bd, cfg)
    if bd.mixer != "attn":
        raise NotImplementedError(
            f"{what} requires attention mixers, got {bd.mixer!r} "
            f"({_ATTN_ONLY[what]})")


def init(gen: torch.Generator, bd: BlockDef, cfg: ModelConfig,
         device) -> dict:
    """One block's random serving weights from ``gen``; a mixer-only
    block (``ffn="none"``) has no ``norm_ffn`` and no ``ffn``."""
    _require_ported(bd, cfg)
    if bd.mixer == "mla":
        mixer = mla.init(gen, _mla_cfg(cfg), cfg.quant, device,
                         cfg.compute_dtype)
    elif bd.mixer == "rglru":
        mixer = rglru.init(gen, _rglru_cfg(cfg), cfg.quant, device)
    elif bd.mixer == "ssd":
        mixer = ssd.init(gen, _ssd_cfg(cfg), cfg.quant, device)
    else:
        mixer = attention.init(gen, _attn_cfg(cfg, bd), cfg.quant, device)
    params = {"norm_mixer": rmsnorm_init(cfg.d_model, device),
              "mixer": mixer}
    if bd.ffn != "none":
        params["norm_ffn"] = rmsnorm_init(cfg.d_model, device)
        params["ffn"] = (moe.init(gen, _moe_cfg(cfg), cfg.quant, device,
                                  cfg.compute_dtype) if bd.ffn == "moe" else
                         ffn.init(gen, cfg.d_model, cfg.d_ff, cfg.quant,
                                  device, cfg.ffn_kind))
    if cfg.post_norms:
        params["postnorm_mixer"] = rmsnorm_init(cfg.d_model, device)
        if bd.ffn != "none":
            params["postnorm_ffn"] = rmsnorm_init(cfg.d_model, device)
    return params


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to ``dtype``
    and back. The reference differentiates a bf16 residual sum, whose
    gradient is bf16, where the port's FFN norm reads that sum in f32."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


class _Rounded(torch.autograd.Function):
    """``x`` rounded to ``dtype``, kept in x's (wider) dtype, with the
    gradient passed through unrounded: an RMSNorm output that several
    projections read, whose gradients XLA sums in f32 (it drops the
    rounding of their bf16 sum)."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def require_trainable(bd: BlockDef, cfg: ModelConfig) -> None:
    """Training is ported for attention blocks with a dense FFN of every
    kind (SwiGLU, gemma2's GeGLU, musicgen's no-gate GELU), with gemma2's
    sandwich post-norms and softcaps; MLA, MoE and the recurrent mixers
    wait for ROADMAP A9b."""
    _require_ported(bd, cfg)
    if bd.mixer == "mla":
        raise NotImplementedError(
            "training MLA blocks (the latent projections' gradients) is "
            "not ported (ROADMAP A9b)")
    if bd.mixer in RECURRENT:
        raise NotImplementedError(
            f"training {bd.mixer!r} blocks (the recurrent scan's gradient) "
            "is not ported (ROADMAP A9b)")
    if bd.ffn == "moe":
        raise NotImplementedError(
            "training MoE blocks (the router, the Switch loss and grads "
            "through both dispatches) is not ported (ROADMAP A9b)")


def init_train(gen: torch.Generator, bd: BlockDef, cfg: ModelConfig,
               device) -> dict:
    """One block's f32 masters (the training path)."""
    require_trainable(bd, cfg)
    params = {"norm_mixer": rmsnorm_init(cfg.d_model, device),
              "mixer": attention.init_train(gen, _attn_cfg(cfg, bd), device),
              "norm_ffn": rmsnorm_init(cfg.d_model, device),
              "ffn": ffn.init_train(gen, cfg.d_model, cfg.d_ff, device,
                                    cfg.ffn_kind)}
    if cfg.post_norms:
        params["postnorm_mixer"] = rmsnorm_init(cfg.d_model, device)
        params["postnorm_ffn"] = rmsnorm_init(cfg.d_model, device)
    return params


def apply_train(params, x: torch.Tensor, positions: torch.Tensor,
                bd: BlockDef, cfg: ModelConfig) -> tuple:
    """One block over the full sequence x (B, S, d_model) (training /
    prefill compute): pre-norm attention and the dense FFN under the
    config's quantization policy, with ``cfg.post_norms`` gemma2's
    RMSNorms of each one's output. ``x`` is bf16, or the f32 output sum of
    the block before it in one pattern group (``model.layer_carries``):
    its norm reads it unrounded, the residual rounded to bf16. Returns
    (the block's output sum unrounded in f32, aux), aux the f32 zero of a
    dense block."""
    require_trainable(bd, cfg)
    quant, dt = cfg.quant, cfg.compute_dtype
    # the norm's input gradient meets the residual's rounded to bf16, as
    # a bf16 input's does
    h = _Rounded.apply(rmsnorm_apply(params["norm_mixer"],
                                     _RoundGrad.apply(x, dt), cfg.norm_eps,
                                     dtype=torch.float32), dt)
    # XLA sums the V and K projections' input gradients rounded to bf16,
    # then adds the query's in f32
    h = attention.apply_train(params["mixer"], h, positions,
                              _attn_cfg(cfg, bd), quant, dt,
                              x_kv=_RoundGrad.apply(h, dt))
    if cfg.post_norms:
        # the post-norms' outputs reach the adds rounded to bf16; XLA
        # hands their backward the gradient sum unrounded (f32 consumers)
        h = _Rounded.apply(rmsnorm_apply(params["postnorm_mixer"], h,
                                         cfg.norm_eps, dtype=torch.float32),
                           dt)
    # XLA fuses the residual add into the FFN's norm, which reads the
    # unrounded f32 sum (as in _decode_tail); the residual stores it bf16
    x_sum = x.to(dt).to(torch.float32) + h.to(torch.float32)
    h = _Rounded.apply(rmsnorm_apply(params["norm_ffn"],
                                     _RoundGrad.apply(x_sum, dt),
                                     cfg.norm_eps, dtype=torch.float32), dt)
    h = ffn.apply(params["ffn"], h, cfg.ffn_kind, dt, quant)
    if cfg.post_norms:
        h = _Rounded.apply(rmsnorm_apply(params["postnorm_ffn"], h,
                                         cfg.norm_eps, dtype=torch.float32),
                           dt)
    x = x_sum.to(dt).to(torch.float32) + h.to(torch.float32)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _decode_tail(params, x: torch.Tensor, h: torch.Tensor, norm_eps: float,
                 dt: torch.dtype, ffn_kind: str = "swiglu",
                 post_norms: bool = False, moe_cfg=None) -> torch.Tensor:
    """Residual add + channel mixer (the dense FFN, or with ``moe_cfg``
    the mixture of experts, without the auxiliary loss that the reference's
    serving paths drop; with ``ffn_kind`` None, none: the block returns
    the first sum), with
    ``post_norms`` gemma2's RMSNorms of the mixer's output ``h`` and of
    the FFN's output.

    The reference's jitted step fuses a residual add into the RMSNorm
    that follows it, and XLA's excess-precision rule then hands the norm
    the unrounded f32 sum, while the residual stream itself is stored
    rounded to bf16. The port computes the same values: the FFN's norm
    takes the unrounded first sum, and the block returns its own output
    sum unrounded in f32, as the next block of the same scanned pattern
    iteration receives it; the model rounds it to ``dt`` where the scan
    stores it (``model.layer_carries``). ``x`` may be such a sum: the
    residual reads it rounded. The post-norms' outputs reach the adds
    rounded to bf16 (measured against the jitted reference).
    """
    if post_norms:
        h = rmsnorm_apply(params["postnorm_mixer"], h, norm_eps)
    x_sum = x.to(dt).to(torch.float32) + h.to(torch.float32)
    if ffn_kind is None:
        return x_sum
    h = rmsnorm_apply(params["norm_ffn"], x_sum, norm_eps, dtype=dt)
    if moe_cfg is None:
        h = ffn.apply(params["ffn"], h, ffn_kind, dt)
    else:
        h = moe.apply(params["ffn"], h, moe_cfg, dt)
    if post_norms:
        h = rmsnorm_apply(params["postnorm_ffn"], h, norm_eps)
    return x_sum.to(dt).to(torch.float32) + h.to(torch.float32)


def _tail(params, x: torch.Tensor, h: torch.Tensor, bd: BlockDef,
          cfg: ModelConfig) -> torch.Tensor:
    return _decode_tail(params, x, h, cfg.norm_eps, cfg.compute_dtype,
                        None if bd.ffn == "none" else cfg.ffn_kind,
                        cfg.post_norms,
                        _moe_cfg(cfg) if bd.ffn == "moe" else None)


def _norm_in(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The mixer's pre-norm of ``x`` (bf16, or a carried f32 sum)."""
    return rmsnorm_apply(params["norm_mixer"], x, cfg.norm_eps,
                         dtype=cfg.compute_dtype)


def _init_state(batch: int, bd: BlockDef, cfg: ModelConfig,
                device) -> dict:
    if bd.mixer == "rglru":
        return rglru.init_state(batch, _rglru_cfg(cfg), device)
    return ssd.init_state(batch, _ssd_cfg(cfg), device)


def init_cache(batch: int, max_seq: int, bd: BlockDef, cfg: ModelConfig,
               device) -> dict:
    """The block's empty contiguous cache: ring buffers of K/V for
    attention, the latent cache for MLA, a recurrent mixer's zero state
    of ``batch`` rows."""
    _require_ported(bd, cfg)
    if bd.mixer == "mla":
        return mla.init_cache(batch, max_seq, _mla_cfg(cfg), device)
    if bd.mixer in RECURRENT:
        return _init_state(batch, bd, cfg, device)
    return attention.init_cache(batch, max_seq, _attn_cfg(cfg, bd),
                                cfg.quant, device)


def _recurrent_decode(params, h: torch.Tensor, state: dict, bd: BlockDef,
                      cfg: ModelConfig, scanned: bool) -> torch.Tensor:
    """A recurrent mixer's one-token step over its normed input ``h``,
    ``state`` updated in place (``scanned``: ``rglru.apply_decode``)."""
    if bd.mixer == "rglru":
        return rglru.apply_decode(params, h, state, _rglru_cfg(cfg),
                                  cfg.compute_dtype, scanned=scanned)
    return ssd.apply_decode(params, h, state, _ssd_cfg(cfg),
                            cfg.compute_dtype)


def apply_decode(params, x: torch.Tensor, cache: dict, pos: int,
                 bd: BlockDef, cfg: ModelConfig,
                 scanned: bool = True) -> torch.Tensor:
    """One-token decode of one block against its contiguous cache: x (B,
    1, d_model) at the shared position ``pos``; ``cache`` in place
    (``scanned``: whether the reference scans this layer,
    ``rglru.apply_decode``). Like every step function here it returns the
    block's output sum unrounded in f32 (:func:`_decode_tail`)."""
    _require_ported(bd, cfg)
    h = _norm_in(params, x, cfg)
    if bd.mixer == "mla":
        h = mla.apply_decode(params["mixer"], h, cache, pos, _mla_cfg(cfg),
                             cfg.compute_dtype)
    elif bd.mixer in RECURRENT:
        h = _recurrent_decode(params["mixer"], h, cache, bd, cfg, scanned)
    else:
        h = attention.apply_decode(params["mixer"], h, cache, pos,
                                   _attn_cfg(cfg, bd), cfg.quant,
                                   cfg.compute_dtype)
    return _tail(params, x, h, bd, cfg)


def _attn_prefill(params, x: torch.Tensor, positions: torch.Tensor,
                  bd: BlockDef, cfg: ModelConfig, keys=None) -> tuple:
    """The dense prefill of one block over ``x`` (B, S, d_model) at
    ``positions`` (B, S): the QKV projection and RoPE shared with every
    decode path (``attention._project_decode_qkv``), attention over the
    cache representation of the new K/V (``cache_kv_view``), preceded by
    ``keys`` = (K, V, key positions) of a cached prefix if given, then
    the output projection and the block's tail. Returns (x, k, v)."""
    _require_ported(bd, cfg)
    acfg, dt = _attn_cfg(cfg, bd), cfg.compute_dtype
    b, s, _ = x.shape
    h = _norm_in(params, x, cfg)
    q, k, v = attention._project_decode_qkv(
        params["mixer"], h, positions, acfg, dt,
        attention.rope_len(int(positions.max()) + 1))
    ks, vs = attention.cache_kv_view(k, v, acfg, cfg.quant)
    kpos = positions
    if keys is not None:
        kp, vp, pref_pos = keys
        ks, vs = torch.cat([kp, ks], dim=1), torch.cat([vp, vs], dim=1)
        kpos = torch.cat([pref_pos, positions[0]])
    out = attention._attend_chunked(q, ks, vs, positions, kpos, acfg)
    h = linear.apply(params["mixer"]["wo"], out.reshape(b, s, -1), dt)
    return _tail(params, x, h, bd, cfg), k, v


def prefill_block(params, x: torch.Tensor, positions: torch.Tensor,
                  bd: BlockDef, cfg: ModelConfig, max_seq: int) -> tuple:
    """Dense prefill of one block that also builds its contiguous cache:
    x (B, S, d_model) at ``positions`` (B, S). Returns (x, cache). An MLA
    block runs the mixer's full forward, then builds its latent cache
    from the same normed input, as the reference's; a recurrent block
    runs its forward and returns its final state as the cache."""
    if bd.mixer in RECURRENT:
        _require_ported(bd, cfg)
        xn, dt = _norm_in(params, x, cfg), cfg.compute_dtype
        if bd.mixer == "rglru":
            h, state = rglru.prefill(params["mixer"], xn, _rglru_cfg(cfg),
                                     dt)
        else:
            h, state = ssd.prefill_state(params["mixer"], xn,
                                         _ssd_cfg(cfg), dt)
        return _tail(params, x, h, bd, cfg), state
    if bd.mixer == "mla":
        xn, mcfg = _norm_in(params, x, cfg), _mla_cfg(cfg)
        h = mla.apply_train(params["mixer"], xn, positions, mcfg,
                            cfg.compute_dtype)
        cache = mla.prefill_cache(params["mixer"], xn, positions, mcfg,
                                  max_seq, cfg.compute_dtype)
        return _tail(params, x, h, bd, cfg), cache
    x, k, v = _attn_prefill(params, x, positions, bd, cfg)
    return x, attention.prefill_cache(positions, _attn_cfg(cfg, bd),
                                      cfg.quant, k, v, max_seq)


def prefill_block_tail(params, x: torch.Tensor, positions: torch.Tensor,
                       pool: dict, prefix_pages: torch.Tensor, bd: BlockDef,
                       cfg: ModelConfig, max_seq: int) -> tuple:
    """Prefill of a prompt's uncached tail against its cached prefix
    pages: x (1, S_tail, d_model) at absolute ``positions`` (1, S_tail),
    ``prefix_pages`` the ``ceil(pos0 / page_size)`` pages holding the
    prefix's ``pos0 = positions[0, 0]`` tokens in ``pool`` (read only).
    The gather pulls whole pages, so a hit that ends mid-page leaves rows
    past ``pos0`` that key position -1 masks. Returns (x, the tail's
    cache at relative slots 0.., for installing into its pages)."""
    _require_attn(bd, cfg, "prefix-cached prefill")
    acfg = _attn_cfg(cfg, bd)
    kp, vp = attention.gather_page_kv(pool, prefix_pages, acfg, cfg.quant,
                                      cfg.compute_dtype)
    pos0 = positions[0, 0]
    pref = torch.arange(kp.shape[1], dtype=positions.dtype,
                        device=x.device)
    pref = torch.where(pref < pos0, pref, torch.full_like(pref, -1))
    x, k, v = _attn_prefill(params, x, positions, bd, cfg,
                            keys=(kp, vp, pref))
    return x, attention.prefill_cache(positions - positions[:, :1], acfg,
                                      cfg.quant, k, v, max_seq)


def init_paged_cache(num_pages: int, page_size: int, bd: BlockDef,
                     cfg: ModelConfig, device, tiered: bool = False,
                     num_slots: int = 0) -> dict:
    """The block's paged serving cache: an attention layer's page pool
    (shared page table); a recurrent mixer's state rows, one for each of
    ``num_slots`` decode slots (its state is O(1) a sequence, so paging
    buys nothing). Tiered pools and MLA raise with the reference's
    messages."""
    _require_ported(bd, cfg)
    if bd.mixer == "attn":
        return attention.init_paged_pool(num_pages, page_size,
                                         _attn_cfg(cfg, bd), cfg.quant,
                                         device, tiered=tiered)
    if tiered:
        raise NotImplementedError(
            f"tiered KV pools require attention mixers, got {bd.mixer!r}")
    if bd.mixer in RECURRENT:
        if num_slots < 1:
            raise ValueError("recurrent state rows need num_slots >= 1")
        return _init_state(num_slots, bd, cfg, device)
    raise NotImplementedError(
        f"paged serving does not support mixer {bd.mixer!r} yet (MLA "
        "latent caches need their own pool layout — see ROADMAP)")


def apply_ragged_step(params, x: torch.Tensor, cache: dict,
                      page_rows: torch.Tensor, row_start: torch.Tensor,
                      seq_lens: torch.Tensor, bd: BlockDef,
                      cfg: ModelConfig, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """One ragged engine step of one block: x (R, W, d_model); the
    block's page pool ``cache`` is updated in place (a tiered pool with
    its ``page_fmts`` / ``mixed_fmts``)."""
    _require_attn(bd, cfg, "the ragged engine step")
    h = _norm_in(params, x, cfg)
    h = attention.apply_ragged(params["mixer"], h, cache, page_rows,
                               row_start, seq_lens, _attn_cfg(cfg, bd),
                               cfg.quant, cfg.compute_dtype,
                               page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    return _tail(params, x, h, bd, cfg)


def apply_verify_paged(params, x: torch.Tensor, cache: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       bd: BlockDef, cfg: ModelConfig, page_fmts=None,
                       mixed_fmts=None) -> torch.Tensor:
    """Multi-token paged verify of one block: x (B, Tq, d_model), pos (B,)
    each slot's first position; ``cache`` is updated in place."""
    _require_attn(bd, cfg, "speculative verify")
    h = _norm_in(params, x, cfg)
    h = attention.apply_verify_paged(params["mixer"], h, cache, page_rows,
                                     pos, _attn_cfg(cfg, bd), cfg.quant,
                                     cfg.compute_dtype, page_fmts=page_fmts,
                                     mixed_fmts=mixed_fmts)
    return _tail(params, x, h, bd, cfg)


def apply_decode_paged(params, x: torch.Tensor, cache: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       bd: BlockDef, cfg: ModelConfig, page_fmts=None,
                       mixed_fmts=None, scanned: bool = True) -> torch.Tensor:
    """Per-slot decode of one block: x (B, 1, d_model), pos (B,); an
    attention layer's pool or a recurrent mixer's state rows (every slot's
    row steps, inactive ones too, as in the reference: admission
    overwrites them) are updated in place (``scanned`` as in
    :func:`apply_decode`)."""
    _require_ported(bd, cfg)
    if bd.mixer in RECURRENT:
        h = _recurrent_decode(params["mixer"], _norm_in(params, x, cfg),
                              cache, bd, cfg, scanned)
        return _tail(params, x, h, bd, cfg)
    if bd.mixer != "attn":
        raise NotImplementedError(f"paged decode for mixer {bd.mixer!r}")
    return apply_verify_paged(params, x, cache, page_rows, pos, bd, cfg,
                              page_fmts=page_fmts, mixed_fmts=mixed_fmts)


def apply_prefill_chunked(params, x: torch.Tensor, cache: dict,
                          page_rows: torch.Tensor, pos: torch.Tensor,
                          num_valid: torch.Tensor, bd: BlockDef,
                          cfg: ModelConfig, page_fmts=None,
                          mixed_fmts=None) -> torch.Tensor:
    """One chunk of paged prefill of one block: x (B, C, d_model), pos
    (B,) chunk starts, num_valid (B,) real tokens in the chunk."""
    _require_attn(bd, cfg, "chunked paged prefill")
    h = _norm_in(params, x, cfg)
    h = attention.apply_prefill_chunked(
        params["mixer"], h, cache, page_rows, pos, num_valid,
        _attn_cfg(cfg, bd), cfg.quant, cfg.compute_dtype,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    return _tail(params, x, h, bd, cfg)


def megakernel_reject_reason(cfg: ModelConfig):
    """Why the layer-fused megakernel cannot serve ``cfg`` (None: it can).

    The reference's static rungs of the serve engine's ladder for
    ``step_mode="megakernel"``, string for string, for every rung this
    package's ``ModelConfig`` can express (the engine adds the runtime
    rungs). Each string names why the engine falls back to the per-layer
    ragged step.
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
    if cfg.post_norms:
        return "sandwich post-norms (not folded into the fused layer tail)"
    if cfg.quant.enabled and cfg.quant.quantize_acts:
        return ("activation quantization (qat_matmul's custom-vjp pallas "
                "path cannot nest inside the megakernel)")
    if not (cfg.quant.enabled and cfg.quant.quantize_kv_cache):
        return "wide bf16 KV pool (no MX page walk to fuse over)"
    return None
