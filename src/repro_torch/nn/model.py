"""LM assembly for serving (port of ``repro.nn.model``): embedding ->
attention blocks -> final norm -> LM head, one engine step at a time: the
ragged step, or the split step's decode / verify and prefill chunk.

Parameters are a plain dict::

  {"embedding": {"embed": (V, D) bf16[, "head": (D, V) bf16]},
   "layers": [block params, in iter_layer_blocks order],
   "final_norm": {"scale": (D,) f32}}

Linear weights are stored prepared (fake-quantized once, bf16; see
``nn.linear``). The reference scans stacked groups; PyTorch runs eagerly,
so layers are a list and the cache is a list of per-layer page pools.
"""
from __future__ import annotations

import numpy as np
import torch

from . import blocks, embedding, linear
from .config import ModelConfig
from .norms import rmsnorm_apply, rmsnorm_init


def iter_layer_blocks(cfg: ModelConfig):
    """Yield ``(param_key, group_index, bd)`` for every decoder block in
    execution order, as the reference does: prologue, ``num_groups``
    repetitions of the pattern, epilogue (``group_index`` None for
    unscanned blocks). Index ``l`` of ``params["layers"]`` is the l-th."""
    for j, bd in enumerate(cfg.prologue):
        yield f"prologue{j}", None, bd
    for g in range(cfg.num_groups):
        for i, bd in enumerate(cfg.pattern):
            yield f"block{i}", g, bd
    for j, bd in enumerate(cfg.epilogue):
        yield f"epilogue{j}", None, bd


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random weights from ``gen`` (a generator on ``device``), prepared
    layer by layer so no f32 copy of the whole model is ever held."""
    return {
        "embedding": embedding.init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.tied_embeddings, device,
                                    cfg.compute_dtype),
        "layers": [blocks.init(gen, bd, cfg, device)
                   for _, _, bd in iter_layer_blocks(cfg)],
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }


def params_from_jax(params_np, cfg: ModelConfig, device) -> dict:
    """The reference's param tree (numpy leaves) -> this package's params.

    Stacked ``params["groups"]["block{i}"]`` leaves carry a leading layer
    axis; each layer's slice is taken in :func:`iter_layer_blocks` order.
    Linear weights are fake-quantized here exactly as the reference does
    at every use, so both packages compute with the same weights.
    """
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def convert(tree):
        if "w" in tree and not isinstance(tree["w"], dict):
            return {"w": linear.prepare_weight(tensor(tree["w"]), cfg.quant,
                                               cfg.compute_dtype)}
        if "scale" in tree and not isinstance(tree["scale"], dict):
            return {"scale": tensor(tree["scale"])}
        return {k: convert(v) for k, v in tree.items()}

    layers = []
    for key, g, _ in iter_layer_blocks(cfg):
        sub = params_np[key] if g is None else params_np["groups"][key]
        if g is not None:
            sub = _slice_tree(sub, g)
        layers.append(convert(sub))
    emb = {k: tensor(v).to(cfg.compute_dtype)
           for k, v in params_np["embedding"].items()}
    return {"embedding": emb, "layers": layers,
            "final_norm": convert(params_np["final_norm"])}


def _slice_tree(tree, g: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, tiered: bool = False) -> list:
    """One page pool per layer (shared page table, like the reference):
    MX, wide bf16 without an MX cache, or mixed-format with ``tiered``.
    ``num_pages`` counts every physical page, a trash page the caller
    reserves included."""
    return [blocks.init_paged_cache(num_pages, page_size, bd, cfg, device,
                                    tiered=tiered)
            for _, _, bd in iter_layer_blocks(cfg)]


def _walk_blocks(apply_fn, params, cfg: ModelConfig, cache: list, x):
    for bp, pool, (_, _, bd) in zip(params["layers"], cache,
                                    iter_layer_blocks(cfg)):
        x = apply_fn(bp, x, pool, bd)
    return x


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return embedding.logits(params["embedding"], x, cfg.compute_dtype)


def decode_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      pos: torch.Tensor, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """The split step's decode: tokens (B, 1), page_rows (B, P) (-1 =
    unallocated), pos (B,) each slot's position. Every layer writes its
    K/V on the host side (inactive slots' writes drop) and attends by
    ``cfg.decode_kernel``; ``cache`` is updated in place. Returns logits
    (B, 1, V) f32. A tiered cache passes ``page_fmts`` / ``mixed_fmts``
    (fused only)."""
    return verify_step_paged(params, cfg, cache, tokens, page_rows, pos,
                             page_fmts=page_fmts, mixed_fmts=mixed_fmts)


def verify_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      pos: torch.Tensor, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """Speculative verify: tokens (B, Tq) at positions ``pos .. pos + Tq
    - 1``, every token's K/V written before the per-row causal page walk
    (``Tq == 1`` is :func:`decode_step_paged`). Returns logits (B, Tq, V)
    f32; ``cache`` is updated in place."""
    x = embedding.embed(params["embedding"], tokens, cfg.compute_dtype)
    x = _walk_blocks(lambda bp, x, pool, bd: blocks.apply_verify_paged(
        bp, x, pool, page_rows, pos, bd, cfg, page_fmts=page_fmts,
        mixed_fmts=mixed_fmts), params, cfg, cache, x)
    return _head(params, cfg, x)


def prefill_chunk_paged(params, cfg: ModelConfig, cache: list,
                        tokens: torch.Tensor, page_rows: torch.Tensor,
                        pos: torch.Tensor, num_valid: torch.Tensor,
                        logit_idx: torch.Tensor, page_fmts=None,
                        mixed_fmts=None) -> torch.Tensor:
    """One fixed-size chunk of paged prefill: tokens (B, C) at positions
    ``pos .. pos + C - 1`` (``pos`` page-aligned), num_valid (B,) real
    tokens, logit_idx (B,) the row whose logits to return. Returns logits
    (B, 1, V) f32, gathered before the final norm as the reference does;
    ``cache`` is updated in place."""
    x = embedding.embed(params["embedding"], tokens, cfg.compute_dtype)
    x = _walk_blocks(lambda bp, x, pool, bd: blocks.apply_prefill_chunked(
        bp, x, pool, page_rows, pos, num_valid, bd, cfg,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts), params, cfg, cache, x)
    x = x[torch.arange(x.shape[0], device=x.device), logit_idx.long()]
    return _head(params, cfg, x[:, None])


def ragged_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      row_start: torch.Tensor, seq_lens: torch.Tensor,
                      logit_idx: torch.Tensor, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """One ragged engine step: tokens (R, W), page_rows (R, P), row_start
    (R,), seq_lens (R,) = row_start + n_new, logit_idx (R,).

    Every layer's new K/V is quantize-written into its pages inside the
    ragged kernel; ``cache`` is updated in place. Returns logits (R, V)
    f32 of row ``logit_idx`` (clamped onto the row's last real token),
    gathered before the final norm and head as the reference does. The
    reference's ``num_logits > 1`` (speculative verify windows) is not
    ported yet. A tiered cache passes ``page_fmts``, one (NP,) int32
    tensor of format ids shared by every layer like the page table, and
    its candidate formats ``mixed_fmts``.
    """
    x = embedding.embed(params["embedding"], tokens, cfg.compute_dtype)
    x = _walk_blocks(lambda bp, x, pool, bd: blocks.apply_ragged_step(
        bp, x, pool, page_rows, row_start, seq_lens, bd, cfg,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts), params, cfg, cache, x)
    last = torch.clamp(seq_lens - row_start - 1, min=0)
    idx = torch.minimum(torch.clamp(logit_idx, min=0), last).long()
    x = x[torch.arange(x.shape[0], device=x.device), idx]
    return _head(params, cfg, x)
