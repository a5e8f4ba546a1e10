"""LM assembly (port of ``repro.nn.model``): embedding -> attention, MLA
or recurrent (RG-LRU, SSD) blocks (dense, MoE or no channel mixers) ->
final norm -> LM head. As in the reference, ``forward``, ``prefill``,
``decode_step`` and ``loss_fn`` also take precomputed ``embeds`` (B, S,
d_model) in place of tokens (llava's vision stub), and a config with
``num_codebooks`` > 1 (musicgen) takes codebook tokens (..., CB), sums the
codebooks' embeddings (codebook c indexes rows ``c * vocab_size ..`` of
one table) and returns (..., CB, V) logits from every head. Serving
runs one engine step at a time: the ragged step, its layer-fused
megakernel form, or the split step's decode / verify and prefill chunk;
and the contiguous-cache path of dense prefill (``prefill``,
``prefill_with_prefix``) and one-token ``decode_step``.

Parameters are a plain dict::

  {"embedding": {"embed": (V * CB, D) bf16[, "head": (D, V * CB) bf16]},
   "layers": [block params, in iter_layer_blocks order],
   "layer_stack": block params with a leading (L,) axis (uniform stacks),
   "final_norm": {"scale": (D,) f32}}

Linear weights are stored prepared (fake-quantized once, bf16; see
``nn.linear``). The reference scans stacked groups; PyTorch runs eagerly,
so layers are a list and the cache is a list of per-layer page pools.
Where every layer is the same block, each leaf lives in one (L, ...)
tensor (``params["layer_stack"]``, ``PagedCache.stack``) and the
per-layer entries are its slices: the per-layer steps read the slices,
the megakernel the stacks, one copy of each.

Training (:func:`init_train`, :func:`forward`, :func:`loss_fn`) keeps f32
masters in the same per-layer layout, without stacks: autograd would
write a full-size gradient of a stacked leaf for every layer that indexes
it. :func:`reference_layout` arranges any such tree (params, gradients,
optimizer moments) in the reference's structure, its stacked leaves as
lists of the layers' tensors, for checkpoints and reductions in the
reference's leaf order.

The contiguous cache has the reference's pytree structure, so the two
packages' caches compare leaf by leaf::

  {"prologue{j}": block cache, "groups": (block cache of pattern block i
   with every leaf stacked over num_groups, ...), "epilogue{j}": ...}

each block cache being ``attention.init_cache``'s dict (an MLA block's:
``mla.init_cache``'s latent cache; a recurrent block's: its state,
``{"h", "conv"}``); :func:`cache_layers` gives its
per-layer views in execution order. A stack whose blocks differ (a
prologue block ahead of the pattern, as deepseek-v2-lite's dense-FFN
first layer before its MoE layers) keeps a list of per-layer params and
no ``layer_stack``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import host_math

from . import blocks, embedding, linear, mla
from . import common as C
from .config import ModelConfig
from .norms import rmsnorm_apply, rmsnorm_init, window_sum


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


def _uniform(cfg: ModelConfig) -> bool:
    """Whether every layer is the same block (one stack per leaf)."""
    return len({bd for _, _, bd in iter_layer_blocks(cfg)}) == 1


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer_params(cfg: ModelConfig, layers) -> dict:
    """``{"layers": [...]}`` from the per-layer trees that ``layers``
    yields; for a uniform stack each leaf is copied into its slice of an
    (L, ...) tensor as the layer is made, so only one layer is held twice,
    and ``"layer_stack"`` holds the stacks."""
    if not _uniform(cfg):
        return {"layers": list(layers)}
    stack, views = None, []
    for li, tree in enumerate(layers):
        if stack is None:
            stack = _tree_map(lambda t: torch.empty(
                (cfg.num_layers, *t.shape), dtype=t.dtype, device=t.device),
                tree)
        _tree_map(lambda s, t: s[li].copy_(t), stack, tree)
        views.append(_tree_map(lambda s: s[li], stack))
    return {"layers": views, "layer_stack": stack}


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random weights from ``gen`` (a generator on ``device``), prepared
    layer by layer so no f32 copy of the whole model is ever held."""
    return {
        "embedding": embedding.init(gen, table_rows(cfg), cfg.d_model,
                                    cfg.tied_embeddings, device,
                                    cfg.compute_dtype),
        **_layer_params(cfg, (blocks.init(gen, bd, cfg, device)
                              for _, _, bd in iter_layer_blocks(cfg))),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }


def params_from_jax(params_np, cfg: ModelConfig, device) -> dict:
    """The reference's param tree (numpy leaves) -> this package's params.

    Stacked ``params["groups"]["block{i}"]`` leaves carry a leading layer
    axis; each layer's slice is taken in :func:`iter_layer_blocks` order.
    Linear weights are fake-quantized here exactly as the reference does
    at every use, so both packages compute with the same weights: an MoE
    block's ``experts`` stacks (E, d_in, d_out) expert by expert along
    d_in; its router stays f32. An MLA mixer's ``wk_b`` and ``wv_b`` also
    keep their plain bf16 cast (``mla.absorbed_weight``), which the
    reference's absorbed decode multiplies. The recurrent mixers' f32
    leaves (convolutions, RG-LRU gates and ``lam``, SSD's ``A_log``,
    ``dt_bias`` and ``D``) carry over as they are.
    """
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def convert(tree):
        if not isinstance(tree, dict):
            return tensor(tree)
        if "experts" in tree:
            return {"router": {"w": tensor(tree["router"]["w"])},
                    "experts": {k: torch.stack([linear.prepare_weight(
                        tensor(e), cfg.quant, cfg.compute_dtype) for e in v])
                        for k, v in tree["experts"].items()},
                    **{k: convert(v) for k, v in tree.items()
                       if k not in ("router", "experts")}}
        if "wkv_a" in tree:
            return {k: (mla.absorbed_weight(tensor(v["w"]), cfg.quant,
                                            cfg.compute_dtype)
                        if k in ("wk_b", "wv_b") else convert(v))
                    for k, v in tree.items()}
        if "w" in tree and not isinstance(tree["w"], dict):
            return {"w": linear.prepare_weight(tensor(tree["w"]), cfg.quant,
                                               cfg.compute_dtype)}
        if "scale" in tree and not isinstance(tree["scale"], dict):
            return {"scale": tensor(tree["scale"])}
        return {k: convert(v) for k, v in tree.items()}

    def layers():
        for key, g, _ in iter_layer_blocks(cfg):
            sub = params_np[key] if g is None else params_np["groups"][key]
            yield convert(sub if g is None else _slice_tree(sub, g))

    emb = {k: tensor(v).to(cfg.compute_dtype)
           for k, v in params_np["embedding"].items()}
    return {"embedding": emb, **_layer_params(cfg, layers()),
            "final_norm": convert(params_np["final_norm"])}


def _slice_tree(tree, g: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


class PagedCache(list):
    """The per-layer page pools, a list as every engine helper walks it.
    For a uniform stack ``stack`` maps each pool leaf to one (L, NP, ...)
    tensor whose slices are the pools' tensors (None otherwise)."""

    def __init__(self, pools, stack=None):
        super().__init__(pools)
        self.stack = stack


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, tiered: bool = False,
                     num_slots: int = 0) -> PagedCache:
    """One page pool per attention layer (shared page table, like the
    reference): MX, wide bf16 without an MX cache, or mixed-format with
    ``tiered``; one state row for each of ``num_slots`` decode slots per
    recurrent layer. ``num_pages`` counts every physical page, a trash
    page the caller reserves included. A uniform stack (mamba2's SSD
    layers too) lays each leaf out as one (L, ...) tensor and hands out
    its slices."""
    def pool(bd):
        return blocks.init_paged_cache(num_pages, page_size, bd, cfg, device,
                                       tiered=tiered, num_slots=num_slots)

    if not _uniform(cfg):
        return PagedCache([pool(bd) for _, _, bd in iter_layer_blocks(cfg)])
    stack = {key: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype,
                              device=t.device)
             for key, t in pool(cfg.all_blocks()[0]).items()}
    return PagedCache([{key: t[li] for key, t in stack.items()}
                       for li in range(cfg.num_layers)], stack)


def reference_cache_leaves(cfg: ModelConfig, cache: list) -> list:
    """The reference's paged-cache pytree leaves (``repro.nn.model.
    init_paged_cache``) in ``jax.tree_util`` order, as ``(pool key, the
    port's layer indices, stacked)``: its top-level keys sorted, each
    prologue and epilogue block one unstacked layer, and the ``groups``
    tuple one leaf a pattern block and pool key, stacked over
    ``num_groups`` on a leading axis. A prefix snapshot's leaves come in
    this order, so snapshots pass between the two packages."""
    n_pro, n_pat = len(cfg.prologue), len(cfg.pattern)
    first_epi = n_pro + cfg.num_groups * n_pat
    blocks_by_key = {f"prologue{j}": [([j], False)] for j in range(n_pro)}
    blocks_by_key.update({f"epilogue{j}": [([first_epi + j], False)]
                          for j in range(len(cfg.epilogue))})
    blocks_by_key["groups"] = [
        ([n_pro + g * n_pat + i for g in range(cfg.num_groups)], True)
        for i in range(n_pat) if cfg.num_groups]
    return [(key, layers, stacked) for name in sorted(blocks_by_key)
            for layers, stacked in blocks_by_key[name]
            for key in sorted(cache[layers[0]])]


def layer_carries(cfg: ModelConfig, into_head: bool = False) -> list:
    """Per layer, in :func:`iter_layer_blocks` order: whether its output
    sum reaches the next layer unrounded, in f32. XLA fuses the residual
    add that ends a block into the next block's RMSNorm where both lie in
    one computation (``blocks._decode_tail``): inside one iteration of the
    reference's scan over the pattern, and between consecutive unscanned
    prologue or epilogue blocks (recurrentgemma's two trailing RG-LRU
    layers); into and out of the scan it carries bf16. With ``into_head``
    (the one-token decode steps, whose final norm reads every row) an
    unscanned last layer also hands the final norm its unrounded sum."""
    last = {"prologue": len(cfg.prologue) - 1, "block": len(cfg.pattern) - 1,
            "epilogue": len(cfg.epilogue) - 1}
    out = []
    for key, _, _ in iter_layer_blocks(cfg):
        kind = key.rstrip("0123456789")
        out.append(int(key[len(kind):]) < last[kind])
    if into_head and out and (cfg.epilogue or not cfg.num_groups):
        out[-1] = True
    return out


def _carried(x: torch.Tensor, carry: bool, cfg: ModelConfig):
    """A block's f32 output sum as the next layer receives it: unrounded
    where ``carry`` (:func:`layer_carries`), else stored in bf16."""
    return x if carry else x.to(cfg.compute_dtype)


def _walk_blocks(apply_fn, params, cfg: ModelConfig, cache: list, x):
    for bp, pool, (_, _, bd), carry in zip(params["layers"], cache,
                                           iter_layer_blocks(cfg),
                                           layer_carries(cfg)):
        x = _carried(apply_fn(bp, x, pool, bd), carry, cfg)
    return x


def table_rows(cfg: ModelConfig) -> int:
    """Rows of the embedding table (and columns of an untied head): the
    vocabulary once for each codebook."""
    return cfg.vocab_size * cfg.num_codebooks


def _codebook_tokens(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Codebook tokens (..., CB), codebook c offset into its vocabulary
    slice ``c * vocab_size ..`` of the table. Tokens of another shape raise
    ``ValueError``, as the reference's broadcast of the offsets does."""
    cb = cfg.num_codebooks
    if tokens.ndim < 3 or tokens.shape[-1] != cb:
        raise ValueError(
            f"{cfg.name} takes codebook tokens (B, S, {cb}); got "
            f"{tuple(tokens.shape)}")
    return tokens + torch.arange(cb, dtype=tokens.dtype,
                                 device=tokens.device) * cfg.vocab_size


def sum_codebooks(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The codebooks' rows x (B, S, CB, D) summed as the reference's
    ``sum(axis=2)`` of bf16: in f32, codebook by codebook in order,
    rounded once to ``dt``."""
    acc = x[:, :, 0].to(torch.float32)
    for c in range(1, x.shape[2]):
        acc = acc + x[:, :, c].to(torch.float32)
    return acc.to(dt)


def _embed(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
           embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``_embed_inputs``: precomputed ``embeds`` cast to
    the compute dtype, or the table rows of ``tokens`` (codebook tokens'
    rows summed, :func:`sum_codebooks`)."""
    if embeds is not None:
        return embeds.to(cfg.compute_dtype)
    if cfg.num_codebooks > 1:
        x = embedding.embed(params["embedding"], _codebook_tokens(
            cfg, tokens), cfg.compute_dtype,
            scale_by_sqrt_dim=cfg.scale_embeds_by_sqrt_dim)
        return sum_codebooks(x, cfg.compute_dtype)
    return embedding.embed(params["embedding"], tokens, cfg.compute_dtype,
                           scale_by_sqrt_dim=cfg.scale_embeds_by_sqrt_dim)


def _codebook_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits (..., CB * V) as (..., CB, V) where the config has codebook
    heads, as every head of the reference reshapes them."""
    if cfg.num_codebooks > 1:
        return logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                              cfg.vocab_size)
    return logits


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _codebook_logits(cfg, embedding.logits(
        params["embedding"], x, cfg.compute_dtype, softcap=cfg.logit_softcap))


# ---------------------------------------------------------------------------
# the contiguous cache: dense prefill and one-token decode
# ---------------------------------------------------------------------------


def _stack_layers(cfg: ModelConfig, layers: list) -> dict:
    """Per-layer block caches (execution order) -> the reference's cache
    structure, each pattern block's leaves stacked over the groups."""
    n_pro, n_pat = len(cfg.prologue), len(cfg.pattern)
    first_epi = n_pro + cfg.num_groups * n_pat
    cache = {f"prologue{j}": layers[j] for j in range(n_pro)}
    cache["groups"] = tuple(
        {key: torch.stack([layers[n_pro + g * n_pat + i][key]
                           for g in range(cfg.num_groups)])
         for key in layers[n_pro + i]}
        for i in range(n_pat)) if cfg.num_groups else ()
    cache.update({f"epilogue{j}": layers[first_epi + j]
                  for j in range(len(cfg.epilogue))})
    return cache


def cache_layers(cfg: ModelConfig, cache: dict) -> list:
    """The contiguous cache's per-layer block caches in
    :func:`iter_layer_blocks` order: views, so writes land in ``cache``."""
    out = []
    for key, g, _ in iter_layer_blocks(cfg):
        if g is None:
            out.append(cache[key])
        else:
            blk = cache["groups"][int(key[len("block"):])]
            out.append({k: leaf[g] for k, leaf in blk.items()})
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> dict:
    """An empty contiguous cache of ``batch`` rows and ``max_seq``
    positions (ring buffers on windowed layers unless
    ``cfg.serve_full_cache``)."""
    return _stack_layers(cfg, [
        blocks.init_cache(batch, max_seq, bd, cfg, device)
        for _, _, bd in iter_layer_blocks(cfg)])


def prefill(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            max_seq: Optional[int] = None, *,
            embeds: Optional[torch.Tensor] = None) -> tuple:
    """Dense prefill of tokens (B, S) (codebook tokens (B, S, CB); or
    ``embeds`` (B, S, d_model)) at positions 0..S-1. Returns (the last
    token's logits (B, 1, V) f32 ((B, 1, CB, V) with codebooks), the
    contiguous cache of ``max_seq`` positions, default S)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    layers = []
    for bp, (_, _, bd), carry in zip(params["layers"], iter_layer_blocks(cfg),
                                     layer_carries(cfg)):
        x, c = blocks.prefill_block(bp, x, positions, bd, cfg, max_seq or s)
        x = _carried(x, carry, cfg)
        layers.append(c)
    return _head(params, cfg, x[:, -1:]), _stack_layers(cfg, layers)


def prefill_with_prefix(params, cfg: ModelConfig, cache: list,
                        tokens: torch.Tensor, prefix_pages: torch.Tensor,
                        pos0: int, max_seq: int) -> tuple:
    """Prefill of a prompt's uncached tail, tokens (1, S_tail) at
    positions ``pos0..``, against the ``ceil(pos0 / page_size)`` pages
    ``prefix_pages`` of the paged ``cache`` (read only) that hold its
    first ``pos0`` tokens; ``pos0`` may end mid-page (a partial-page hit).
    Returns (the last token's logits (1, 1, V) f32, the tail's contiguous
    cache at relative slots 0.. of ``max_seq`` positions, which
    ``kv_cache.install_prefill`` or ``install_prefill_offset`` writes
    into the sequence's tail pages)."""
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    positions = (pos0 + torch.arange(s, dtype=torch.int32,
                                     device=x.device))[None].expand(b, s)
    layers = []
    for bp, pool, (_, _, bd), carry in zip(params["layers"], cache,
                                           iter_layer_blocks(cfg),
                                           layer_carries(cfg)):
        x, c = blocks.prefill_block_tail(bp, x, positions, pool,
                                         prefix_pages, bd, cfg, max_seq)
        x = _carried(x, carry, cfg)
        layers.append(c)
    return _head(params, cfg, x[:, -1:]), _stack_layers(cfg, layers)


def decode_step(params, cfg: ModelConfig, cache: dict,
                tokens: Optional[torch.Tensor] = None,
                pos: Optional[int] = None, *,
                embeds: Optional[torch.Tensor] = None) -> tuple:
    """One-token decode, tokens (B, 1) (codebook tokens (B, 1, CB); or
    ``embeds`` (B, 1, d_model)), every row at position ``pos``, against
    the contiguous ``cache`` (updated in place). Returns (logits (B, 1, V)
    f32 ((B, 1, CB, V) with codebooks), cache)."""
    x = _embed(params, cfg, tokens, embeds)
    for bp, c, (_, g, bd), carry in zip(params["layers"],
                                        cache_layers(cfg, cache),
                                        iter_layer_blocks(cfg),
                                        layer_carries(cfg, into_head=True)):
        x = _carried(blocks.apply_decode(bp, x, c, int(pos), bd, cfg,
                                         scanned=g is not None), carry, cfg)
    return _head(params, cfg, x), cache


def decode_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      pos: torch.Tensor, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """The split step's decode: tokens (B, 1), page_rows (B, P) (-1 =
    unallocated), pos (B,) each slot's position. Every attention layer
    writes its K/V on the host side (inactive slots' writes drop) and
    attends by ``cfg.decode_kernel``; every recurrent layer steps its
    state rows, slot b's row by row b of the batch; ``cache`` is updated
    in place. Returns logits (B, 1, V) f32. A tiered cache passes
    ``page_fmts`` / ``mixed_fmts`` (fused only)."""
    x = _embed(params, cfg, tokens)
    for bp, pool, (_, g, bd), carry in zip(
            params["layers"], cache, iter_layer_blocks(cfg),
            layer_carries(cfg, into_head=True)):
        x = _carried(blocks.apply_decode_paged(
            bp, x, pool, page_rows, pos, bd, cfg, page_fmts=page_fmts,
            mixed_fmts=mixed_fmts, scanned=g is not None), carry, cfg)
    return _head(params, cfg, x)


def verify_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      pos: torch.Tensor, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """Speculative verify: tokens (B, Tq) at positions ``pos .. pos + Tq
    - 1``, every token's K/V written before the per-row causal page walk
    (``Tq == 1`` is :func:`decode_step_paged`). Returns logits (B, Tq, V)
    f32; ``cache`` is updated in place."""
    x = _embed(params, cfg, tokens)
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
    x = _embed(params, cfg, tokens)
    x = _walk_blocks(lambda bp, x, pool, bd: blocks.apply_prefill_chunked(
        bp, x, pool, page_rows, pos, num_valid, bd, cfg, page_fmts=page_fmts,
        mixed_fmts=mixed_fmts), params, cfg, cache, x)
    x = x[torch.arange(x.shape[0], device=x.device), logit_idx.long()]
    return _head(params, cfg, x[:, None])


def ragged_step_paged(params, cfg: ModelConfig, cache: list,
                      tokens: torch.Tensor, page_rows: torch.Tensor,
                      row_start: torch.Tensor, seq_lens: torch.Tensor,
                      logit_idx: torch.Tensor,
                      num_logits: Optional[int] = None, page_fmts=None,
                      mixed_fmts=None) -> torch.Tensor:
    """One ragged engine step: tokens (R, W), page_rows (R, P), row_start
    (R,), seq_lens (R,) = row_start + n_new, logit_idx (R,).

    Decode rows (n_new 1), verify windows (1 + K) and prefill chunks (up
    to W) share the batch. Every layer's new K/V is quantize-written into
    its pages inside the ragged kernel; ``cache`` is updated in place.
    Returns f32 logits gathered before the final norm and head, as the
    reference does: with ``num_logits`` an int, (R, num_logits, V) of rows
    ``logit_idx .. logit_idx + num_logits - 1``, each clamped onto the
    row's last real token (a verify window reads all 1 + K); with None,
    (R, V) of row ``logit_idx`` alone. A tiered cache passes
    ``page_fmts``, one (NP,) int32 tensor of format ids shared by every
    layer like the page table, and its candidate formats ``mixed_fmts``.
    """
    x = _embed(params, cfg, tokens)
    x = _walk_blocks(lambda bp, x, pool, bd: blocks.apply_ragged_step(
        bp, x, pool, page_rows, row_start, seq_lens, bd, cfg,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts), params, cfg, cache, x)
    return _ragged_head(params, cfg, x, row_start, seq_lens, logit_idx,
                        num_logits)


def _ragged_head(params, cfg: ModelConfig, x: torch.Tensor, row_start,
                 seq_lens, logit_idx, num_logits=None) -> torch.Tensor:
    """Rows ``logit_idx ..`` of each ragged row (``num_logits`` of them,
    or one with None), each clamped onto its last real token, then the
    final norm and the head."""
    last = torch.clamp(seq_lens - row_start - 1, min=0)[:, None]
    n = 1 if num_logits is None else num_logits
    idx = logit_idx.long()[:, None] + torch.arange(n, device=x.device)
    idx = torch.minimum(torch.clamp(idx, min=0), last)
    x = x[torch.arange(x.shape[0], device=x.device)[:, None], idx]
    logits = _head(params, cfg, x)
    return logits[:, 0] if num_logits is None else logits


# ---------------------------------------------------------------------------
# the layer-fused megakernel step
# ---------------------------------------------------------------------------

POOL_KEYS = ("k_elems", "k_scales", "v_elems", "v_scales")


def megakernel_stacks(params, cache) -> tuple:
    """(the (L, ...) block params, the four (L, NP, ...) pool tensors in
    ``POOL_KEYS`` order) that the megakernel reads."""
    stack = getattr(cache, "stack", None)
    if params.get("layer_stack") is None or stack is None:
        raise ValueError(
            "the megakernel step reads the (L, ...) stacks that model.init "
            "(or params_from_jax) and init_paged_cache lay out for a "
            "uniform layer stack")
    return params["layer_stack"], tuple(stack[k] for k in POOL_KEYS)


def megakernel_step_paged(params, cfg: ModelConfig, cache: list,
                          tokens: torch.Tensor, page_rows: torch.Tensor,
                          row_start: torch.Tensor, seq_lens: torch.Tensor,
                          logit_idx: torch.Tensor,
                          num_logits: Optional[int] = None, page_fmts=None,
                          mixed_fmts=None) -> torch.Tensor:
    """:func:`ragged_step_paged` with the whole layer stack in one call of
    ``kernels.mx_megakernel_step``, which reads the (L, ...) stacks of
    ``params`` (from :func:`init` or :func:`params_from_jax`) and of
    ``cache`` (from :func:`init_paged_cache`); every argument and the
    result as in :func:`ragged_step_paged`. The embedding, the logit-row
    gather, the final norm and the LM head run outside the kernel, as in
    the reference. Only configurations ``blocks.megakernel_reject_reason``
    accepts come here (the serve engine's ladder)."""
    from repro_torch.kernels import mx_megakernel

    lay, pools = megakernel_stacks(params, cache)
    x = _embed(params, cfg, tokens)
    d = cfg.head_dim
    x, _ = mx_megakernel.mx_megakernel_step(
        x, lay["norm_mixer"]["scale"], *(lay["mixer"][k]["w"] for k in
                                         ("wq", "wk", "wv", "wo")),
        lay["norm_ffn"]["scale"],
        *(lay["ffn"][k]["w"] if k in lay["ffn"] else None
          for k in ("gate", "up", "down")),
        *pools, page_rows, row_start, seq_lens,
        head_dim=d, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        ffn_kind=cfg.ffn_kind, quant=cfg.quant, fmt_name=cfg.quant.fmt,
        block_size=min(cfg.quant.block_size, d), softcap=cfg.attn_softcap,
        window=cfg.all_blocks()[0].window, compute_dtype=cfg.compute_dtype,
        page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    return _ragged_head(params, cfg, x, row_start, seq_lens, logit_idx,
                        num_logits)


# ---------------------------------------------------------------------------
# training: f32 masters, forward and loss
# ---------------------------------------------------------------------------


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` (naming ROADMAP A9b) unless every
    block of ``cfg`` trains here: attention blocks with a dense FFN of
    any kind, post-norms and softcaps included (MLA, MoE and the
    recurrent mixers wait for A9b)."""
    for _, _, bd in iter_layer_blocks(cfg):
        blocks.require_trainable(bd, cfg)


def init_train(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random f32 masters from ``gen`` (a generator on ``device``) in the
    per-layer layout: ``{"embedding", "layers": [...], "final_norm"}``."""
    return {
        "embedding": embedding.init_train(gen, table_rows(cfg), cfg.d_model,
                                          cfg.tied_embeddings, device),
        "layers": [blocks.init_train(gen, bd, cfg, device)
                   for _, _, bd in iter_layer_blocks(cfg)],
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }


def train_params_from_jax(params_np, cfg: ModelConfig, device) -> dict:
    """The reference's param tree (numpy leaves) -> f32 training masters,
    each layer's slice of the stacked ``groups`` leaves in
    :func:`iter_layer_blocks` order, nothing fake-quantized."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return tensor(tree)

    layers = [convert(params_np[key] if g is None else
                      _slice_tree(params_np["groups"][key], g))
              for key, g, _ in iter_layer_blocks(cfg)]
    return {"embedding": convert(params_np["embedding"]), "layers": layers,
            "final_norm": convert(params_np["final_norm"])}


class Stacked(list):
    """The layers' tensors of one stacked leaf of the reference's tree, in
    group order: the leaf is ``torch.stack(self)``."""


def reference_layout(cfg: ModelConfig, tree) -> dict:
    """A per-layer tree (params, gradients, optimizer moments) arranged
    as the reference's param tree: ``groups/block{i}`` leaves are
    :class:`Stacked` lists over the groups, prologue and epilogue blocks
    keep their keys. Leaves are the tree's own tensors."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    groups = {}
    for (key, g, _), layer in zip(iter_layer_blocks(cfg), tree["layers"]):
        if g is None:
            out[key] = layer
        else:
            groups.setdefault(key, []).append(layer)
    if groups:
        out["groups"] = {key: _tree_map(lambda *ls: Stacked(ls), *layers)
                         for key, layers in groups.items()}
    return out


def reference_leaves(cfg: ModelConfig, tree) -> list:
    """The leaves of :func:`reference_layout` in ``jax.tree_util`` order
    (dict keys sorted), each a tensor or a :class:`Stacked` list."""
    return leaves(reference_layout(cfg, tree), stacked=True)


def leaves(tree, stacked: bool = False) -> list:
    """Tensor leaves of a nested dict / list tree in ``jax.tree_util``
    order: dict keys sorted, list entries in order. With ``stacked``, a
    :class:`Stacked` list is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], stacked)]
    if isinstance(tree, (list, tuple)) and not (
            stacked and isinstance(tree, Stacked)):
        return [x for t in tree for x in leaves(t, stacked)]
    return [tree]


def _blocks_train(cfg: ModelConfig, layers: list, bds, carries: list,
                  x: torch.Tensor, positions: torch.Tensor) -> tuple:
    """``blocks.apply_train`` over consecutive blocks, each output sum
    handed on as :func:`layer_carries` says (unrounded f32 inside one
    pattern group, else bf16)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp, bd, carry in zip(layers, bds, carries):
        x, a = blocks.apply_train(bp, x, positions, bd, cfg)
        x = _carried(x, carry, cfg)
        aux = aux + a
    return x, aux


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> tuple:
    """Full-sequence forward of ``tokens`` (B, S) (codebook tokens (B, S,
    CB); or ``embeds`` (B, S, d_model)) over the training masters.
    Returns (logits (B, S, V) f32 ((B, S, CB, V) with codebooks, with
    ``cfg.logit_softcap`` softcapped), aux loss). With
    ``cfg.remat == "full"`` each pattern group's forward is recomputed in
    the backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` around its scan body); prologue and epilogue blocks
    run outside it, as in the reference. Inside a group of several blocks
    (gemma2's local/global pair) each block hands the next its unrounded
    f32 sum, as XLA fuses the scan body (:func:`layer_carries`). On a
    card it first turns off cuBLAS's reduced-precision bf16 reduction and
    TF32 (``common.exact_cuda_products``), as the serving engine does."""
    C.exact_cuda_products((tokens if embeds is None else embeds).device)
    scale = cfg.scale_embeds_by_sqrt_dim
    if embeds is not None:
        x = embeds.to(cfg.compute_dtype)
    elif cfg.num_codebooks > 1:
        x = sum_codebooks(embedding.embed_train(
            params["embedding"], _codebook_tokens(cfg, tokens),
            cfg.compute_dtype, scale_by_sqrt_dim=scale), cfg.compute_dtype)
    else:
        x = embedding.embed_train(params["embedding"], tokens,
                                  cfg.compute_dtype, scale_by_sqrt_dim=scale)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers, carries = params["layers"], layer_carries(cfg)
    n_pro, n_pat = len(cfg.prologue), len(cfg.pattern)
    x, a = _blocks_train(cfg, layers[:n_pro], cfg.prologue, carries[:n_pro],
                         x, positions)
    aux = aux + a
    for g in range(cfg.num_groups):
        lo, hi = n_pro + g * n_pat, n_pro + (g + 1) * n_pat
        args = (cfg, layers[lo:hi], cfg.pattern, carries[lo:hi], x,
                positions)
        if cfg.remat == "full":
            x, a = torch.utils.checkpoint.checkpoint(
                _blocks_train, *args, use_reentrant=False)
        else:
            x, a = _blocks_train(*args)
        aux = aux + a
    first_epi = n_pro + cfg.num_groups * n_pat
    x, a = _blocks_train(cfg, layers[first_epi:], cfg.epilogue,
                         carries[first_epi:], x, positions)
    aux = aux + a
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _codebook_logits(cfg, embedding.logits(
        params["embedding"], x, cfg.compute_dtype,
        softcap=cfg.logit_softcap)), aux


def _lm_losses(lf: torch.Tensor, labels: torch.Tensor) -> tuple:
    """(cross-entropy, z-loss) of f32 logits over the labels >= 0: the
    mean negative log-likelihood and 1e-4 times the mean squared
    log-normalizer."""
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(lf, dim=-1)
    ll = torch.take_along_dim(logp, labels.clamp_min(0)[..., None],
                              dim=-1)[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = -(ll * mask).sum() / denom
    z = torch.logsumexp(lf, dim=-1)
    return ce, 1e-4 * ((z * z) * mask).sum() / denom


class _LMLossCPU(torch.autograd.Function):
    """:func:`_lm_losses` of CPU tensors with the jitted reference's
    gradient, as XLA:CPU computes it: with ``e = exp(x - max)`` (its
    exp, ``host_math.exp``), ``S`` the window sum of ``e`` and ``z =
    log(S) + max`` (its log), the label's cotangent ``c = -mask / denom``
    and the z-loss's ``k = (1 / denom) * 1e-4`` (masked), ``d logits =
    fma(k * (z * 2) / S, e, fma(-c / S, e, onehot(c)))``. torch's own
    gradient parts from it in the last f32 bit of most logits, which the
    softcap's gradient carries into bf16 roundings (reduced gemma2)."""

    @staticmethod
    def forward(ctx, lf, labels):
        ctx.save_for_backward(lf, labels)
        return _lm_losses(lf, labels)

    @staticmethod
    def backward(ctx, g_ce, g_z):
        lf, labels = ctx.saved_tensors
        mask = (labels >= 0).to(torch.float32)
        denom = torch.clamp_min(mask.sum(), 1.0)
        top = lf.amax(dim=-1, keepdim=True)
        e = host_math.exp((lf - top).contiguous())
        s = window_sum(e)[..., None]
        z = host_math.log(s) + top
        c = (-mask / denom * g_ce)[..., None]
        onehot = torch.zeros_like(lf).scatter_add_(
            -1, labels.clamp_min(0)[..., None], c)
        k = (torch.where(mask > 0, (1.0 / denom) * 1e-4, 0.0) * g_z)[..., None]
        d = host_math.fma(-c / s, e, onehot)
        return host_math.fma(k * (z * 2.0) / s, e, d), None


def loss_fn(params, cfg: ModelConfig, batch: dict) -> tuple:
    """Cross-entropy LM loss over the labels >= 0, plus the z-loss
    (1e-4 mean squared log-normalizer) and ``aux_loss_weight`` times the
    aux loss. ``batch``: {"tokens" or "embeds", "labels"}, labels (B, S)
    ((B, S, CB) with codebooks). Returns (total, {"ce", "zloss",
    "aux"}). On CPU tensors the logits' gradient is XLA:CPU's
    (:class:`_LMLossCPU`)."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          batch.get("embeds"))
    labels = batch["labels"].long()
    lf = logits.to(torch.float32)
    if lf.device.type == "cpu":
        ce, zloss = _LMLossCPU.apply(lf, labels)
    else:
        ce, zloss = _lm_losses(lf, labels)
    total = ce + zloss + cfg.aux_loss_weight * aux
    return total, {"ce": ce, "zloss": zloss, "aux": aux}
