"""Grouped-query attention over the paged KV cache (port of
``repro.nn.attention``): the ragged engine step, the split step's
decode, verify and chunked-prefill paths, and the contiguous ring-buffer
cache of dense (monolithic) prefill and fixed-slot decode.

Pools are plain dicts of tensors laid out as in the reference: an MX
pool ``{"k_elems", "k_scales", "v_elems", "v_scales"}`` with elements
``(NP, PS, KVH, D)`` fp8, ``(NP, PS, KVH, D // 2)`` packed fp4 uint8,
or, for a tiered pool, full-width ``(NP, PS, KVH, D)`` uint8 rows whose
formats live in the engine's per-page ids, and scales ``(NP, PS, KVH,
D // k)`` uint8; a wide pool ``{"k", "v"}`` of bf16 ``(NP, PS, KVH, D)``
rows. Every path updates the pool in place; the reference's jitted
steps donate the cache instead.

``AttnConfig.decode_kernel`` selects the split step's attention as in
the reference: ``"fused"`` runs the MX page-walk kernels
(``kernels.mx_attention_verify_fused`` / ``mx_attention_prefill_fused``),
``"einsum"`` the gather-and-dequantize oracle (``_read_cache``,
``_mask``, ``_attend``), which also serves wide pools.

The contiguous cache (:func:`init_cache`) holds the same storage leaves
as a pool, ``(B, T, KVH, .)``, plus ``kpos`` (T,) int32, each slot's
absolute key position (-1: empty). A windowed layer's cache is a ring of
``min(window, max_seq)`` slots unless ``no_ring``. Dense prefill attends
over :func:`cache_kv_view`, the quantize-then-dequantize snap of its K/V,
so full prefill, tail prefill over gathered pages and decode all read
the values the cache holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import QuantConfig, host_math, quantize
from repro_torch.core import formats as F
from repro_torch.kernels import (mx_attention_prefill_fused,
                                 mx_attention_ragged_fused,
                                 mx_attention_verify_fused)

from . import linear
from .norms import WINDOW, window_sum
from .rotary import apply_rope

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window (None = full causal)
    softcap: Optional[float] = None
    # query rows a dense prefill attends at a time (bounds its logits)
    query_chunk: int = 1024
    # paged serving: no ring wraparound, so a prefill cache's slot is the
    # absolute position and it reshapes 1:1 into pages
    no_ring: bool = False
    # the split step's attention: "fused" (MX page-walk kernels) or
    # "einsum" (the gather oracle; wide pools always take it)
    decode_kernel: str = "einsum"


def init(gen: torch.Generator, cfg: AttnConfig, quant: QuantConfig,
         device) -> dict:
    h, kvh, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear.init(gen, dm, h * d, quant, device),
            "wk": linear.init(gen, dm, kvh * d, quant, device),
            "wv": linear.init(gen, dm, kvh * d, quant, device),
            "wo": linear.init(gen, h * d, dm, quant, device)}


def _project_decode_qkv(params, x: torch.Tensor, posv: torch.Tensor,
                        cfg: AttnConfig, compute_dtype, num_positions: int):
    """QKV projection + RoPE at per-token positions ``posv (B, S)`` for
    ``x (B, S, d_model)``; every op is token-row independent. Positions
    lie below ``num_positions``, the RoPE table's length."""
    b, s = x.shape[:2]
    d = cfg.head_dim
    q = linear.apply(params["wq"], x, compute_dtype).reshape(b, s, -1, d)
    k = linear.apply(params["wk"], x, compute_dtype).reshape(b, s, -1, d)
    v = linear.apply(params["wv"], x, compute_dtype).reshape(b, s, -1, d)
    q = apply_rope(q, posv, cfg.rope_theta, num_positions)
    k = apply_rope(k, posv, cfg.rope_theta, num_positions)
    return q, k, v


def _mx_cache(quant: QuantConfig) -> bool:
    return quant.enabled and quant.quantize_kv_cache


def init_paged_pool(num_pages: int, page_size: int, cfg: AttnConfig,
                    quant: QuantConfig, device, tiered: bool = False) -> dict:
    """One layer's global KV page pool (no per-sequence dimension).

    Uniform MX pools store the format's elements (fp4 packs two per
    byte; fp6 rows are D bytes wide, as the reference's ``_cache_arrays``
    lays them out, and the kernels refuse them); without an MX cache the
    pool is wide, ``{"k", "v"}`` in bf16 (the reference's
    ``cache_dtype``). ``tiered=True``
    allocates full-width uint8 rows for any format of the ladder and
    needs an 8-bit hot format, as in the reference.
    """
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    if tiered:
        if not _mx_cache(quant):
            raise ValueError("tiered KV pools require an MX-quantized cache")
        if F.get_format(quant.fmt).bits != 8:
            raise ValueError(
                "tiered KV pools write new pages in the hot format, which "
                f"must be an fp8; got {quant.fmt!r}")
    elif not _mx_cache(quant):
        z = torch.zeros((num_pages, page_size, kvh, d), dtype=torch.bfloat16,
                        device=device)
        return {"k": z, "v": z.clone()}
    fmt = F.get_format(quant.fmt)
    bs = min(quant.block_size, d)
    ed = d // 2 if fmt.packed and not tiered else d
    dtype = torch.uint8 if tiered else fmt.storage_dtype
    shape = (num_pages, page_size, kvh, ed)
    sshape = (num_pages, page_size, kvh, d // bs)
    return {"k_elems": torch.zeros(shape, dtype=dtype, device=device),
            "k_scales": torch.zeros(sshape, dtype=torch.uint8, device=device),
            "v_elems": torch.zeros(shape, dtype=dtype, device=device),
            "v_scales": torch.zeros(sshape, dtype=torch.uint8, device=device)}


# ---------------------------------------------------------------------------
# the split step: host-side page writes, then a page walk or the einsum
# ---------------------------------------------------------------------------


def _quantize_kv_token(k_new: torch.Tensor, v_new: torch.Tensor,
                       cfg: AttnConfig, quant: QuantConfig):
    """The MX cache-write quantization, shared by every host write path
    (``core.quantize`` in f32: -0.0 keeps its sign)."""
    bs = min(quant.block_size, cfg.head_dim)
    return (quantize(k_new.to(torch.float32), quant.fmt, bs),
            quantize(v_new.to(torch.float32), quant.fmt, bs))


def _read_cache(cache: dict, quant: QuantConfig, cfg: AttnConfig, dtype):
    """K/V of a (gathered) cache view in ``dtype``: wide leaves cast, MX
    leaves dequantized in f32 (scales folded, subnormals flushed as the
    reference's arithmetic does) and then rounded to ``dtype``."""
    if "k" in cache:
        return cache["k"].to(dtype), cache["v"].to(dtype)
    bs = min(quant.block_size, cfg.head_dim)
    fmt = F.get_format(quant.fmt)

    def deq(elems, scales):
        return F.dequantize_blocks(elems.view(fmt.storage_dtype), scales,
                                   fmt, bs).to(dtype)

    return (deq(cache["k_elems"], cache["k_scales"]),
            deq(cache["v_elems"], cache["v_scales"]))


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window) -> torch.Tensor:
    """Causal + window + validity mask: (..., S_q, S_k) bool."""
    m = kpos[..., None, :] <= qpos[..., :, None]
    if window is not None:
        m &= kpos[..., None, :] > (qpos[..., :, None] - window)
    m &= kpos[..., None, :] >= 0
    return m


class _Softmax(torch.autograd.Function):
    """Softmax over the last axis, ``e / sum(e)`` with ``e = exp(logits -
    max)``, and the jitted reference's gradient: jax differentiates that
    divide, and XLA:CPU computes ``(g / D - S) * e`` with ``D = sum(e)``
    and ``S`` the sum over the keys of ``(g * (1 / (D * D))) * e``, each
    product contracted into the running sum (:func:`_fma_window_sum`). On
    CPU tensors ``e`` is XLA:CPU's exp (``host_math.exp``; torch's parts
    from it in the last bit of about one value in ten, which the
    backward's ``* e`` carries into near-cancelling key gradients), and
    ``D`` sums as XLA:CPU's reduction does, in windows of 32 keys, each
    in order (``norms.window_sum``): torch's row sum takes another order,
    which moves bf16 probabilities (at reduced deepseek-v2-lite's 19-key
    prompts). On the card torch's exp and sums, and the same
    expression."""

    @staticmethod
    def forward(ctx, logits):
        shifted = logits - logits.amax(dim=-1, keepdim=True)
        if shifted.device.type == "cpu":
            e = host_math.exp(shifted)
            d = window_sum(e)[..., None]
        else:
            e = torch.exp(shifted)
            d = e.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(e, d)
        return e / d

    @staticmethod
    def backward(ctx, g):
        e, d = ctx.saved_tensors
        gm = g * (1.0 / (d * d))
        if e.device.type == "cpu":
            s = _fma_window_sum(gm, e)
        else:
            s = (gm * e).sum(dim=-1, keepdim=True)
        return (g / d + -s) * e


def _fma_window_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b)`` over the last axis (kept), as XLA:CPU reduces a
    product: windows of 32 (``norms.window_sum``'s levels), each one
    chain of fused multiply-adds in order (``host_math.fma``); measured
    at up to 32 keys."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    pad = -n % WINDOW
    if pad:
        lo = pad // 2
        a = torch.nn.functional.pad(a, (lo, pad - lo))
        b = torch.nn.functional.pad(b, (lo, pad - lo))
    a = a.reshape(*a.shape[:-1], -1, WINDOW)
    b = b.reshape(*b.shape[:-1], -1, WINDOW)
    acc = a[..., 0] * b[..., 0]
    for i in range(1, WINDOW):
        acc = host_math.fma(a[..., i], b[..., i], acc)
    return window_sum(acc)[..., None]


def _contract_sg(x: torch.Tensor) -> torch.Tensor:
    """(B, KVH, G, S, T) -> (B, KVH, T, S * G): the keys' rows with the
    query rows and group heads flattened s-major, as XLA lays out the
    contraction of the keys' and values' gradients."""
    b, kvh, g, s, t = x.shape
    return x.permute(0, 1, 4, 3, 2).reshape(b, kvh, t, s * g)


class _QK(torch.autograd.Function):
    """The logits ``q.k`` (B, KVH, G, S, T) of f32 ``qg`` (B, S, KVH, G,
    D) and ``k`` (B, T, KVH, D); the backward's two products in
    XLA:CPU's orders on CPU tensors (``host_math.matmul``): dq sums over
    the keys, dk over (query, group head) pairs."""

    @staticmethod
    def forward(ctx, qg, k):
        ctx.save_for_backward(qg, k)
        return torch.einsum("bskgd,btkd->bkgst", qg, k)

    @staticmethod
    def backward(ctx, gl):
        qg, k = ctx.saved_tensors
        b, s, kvh, g, d = qg.shape
        dq = host_math.matmul(gl.reshape(b, kvh, g * s, -1),
                              k.permute(0, 2, 1, 3))
        dq = dq.reshape(b, kvh, g, s, d).permute(0, 3, 1, 2, 4)
        qsg = qg.permute(0, 2, 1, 3, 4).reshape(b, kvh, s * g, d)
        dk = host_math.matmul(_contract_sg(gl), qsg).permute(0, 2, 1, 3)
        return dq, dk


class _PV(torch.autograd.Function):
    """``P.V`` (B, S, KVH, G, D) of f32 probabilities (B, KVH, G, S, T)
    and values (B, T, KVH, D); the backward's products in XLA:CPU's
    orders on CPU tensors, as :class:`_QK`'s."""

    @staticmethod
    def forward(ctx, probs, v):
        ctx.save_for_backward(probs, v)
        return torch.einsum("bkgst,btkd->bskgd", probs, v)

    @staticmethod
    def backward(ctx, go):
        probs, v = ctx.saved_tensors
        b, kvh, g, s, t = probs.shape
        d = v.shape[-1]
        gog = go.permute(0, 2, 3, 1, 4)  # (B, KVH, G, S, D)
        dp = host_math.matmul(gog.reshape(b, kvh, g * s, d),
                              v.permute(0, 2, 3, 1))
        gsg = gog.permute(0, 1, 3, 2, 4).reshape(b, kvh, s * g, d)
        dv = host_math.matmul(_contract_sg(probs), gsg).permute(0, 2, 1, 3)
        return dp.reshape(b, kvh, g, s, t), dv


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            qpos: torch.Tensor, kpos: torch.Tensor,
            cfg: AttnConfig) -> torch.Tensor:
    """Grouped attention core, the reference's rounding points: f32
    logits of bf16 q.k, f32 softmax, probabilities rounded to q's dtype,
    then P.V summed in f32 and rounded to it. q (B, S, H, D), k/v (B, T,
    KVH, D), qpos (B, S), kpos (B, T). Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = _QK.apply(qg.float(), k.float()) * (d ** -0.5)
    if cfg.softcap:
        logits = host_math.softcap(logits, cfg.softcap)
    mask = _mask(qpos, kpos, cfg.window)[:, None, None]  # (B, 1, 1, S, T)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = _Softmax.apply(logits).to(q.dtype)
    out = _PV.apply(probs.float(), v.float())
    return out.to(q.dtype).reshape(b, s, h, d)


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor, kpos: torch.Tensor,
                    cfg: AttnConfig) -> torch.Tensor:
    """:func:`_attend` over ``cfg.query_chunk`` query rows at a time
    (when the rows divide into several chunks), which bounds the live
    logits; every row's result is :func:`_attend`'s."""
    s, cs = q.shape[1], cfg.query_chunk
    if s <= cs or s % cs:
        return _attend(q, k, v, qpos, kpos, cfg)
    return torch.cat([_attend(q[:, i:i + cs], k, v, qpos[:, i:i + cs],
                              kpos, cfg) for i in range(0, s, cs)], dim=1)


def init_train(gen: torch.Generator, cfg: AttnConfig, device) -> dict:
    """f32 master projections (the training path)."""
    h, kvh, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear.init_master(gen, dm, h * d, device),
            "wk": linear.init_master(gen, dm, kvh * d, device),
            "wv": linear.init_master(gen, dm, kvh * d, device),
            "wo": linear.init_master(gen, h * d, dm, device)}


def apply_train(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: AttnConfig, quant: QuantConfig,
                compute_dtype=torch.bfloat16,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal self-attention over f32 masters (training):
    x (B, S, d_model), positions (B, S) below ``rope_len(S)`` (the RoPE
    table's length; a position past it raises). The projections go
    through ``linear.apply`` under ``quant`` (QAT: #6 on CUDA tensors).
    ``x_kv`` (default ``x``), the same values, feeds the K and V
    projections: a caller may give it a node of its own, where their
    input gradients meet before the query's (``blocks.apply_train``)."""
    b, s, _ = x.shape
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(name, heads):
        src = x if name == "wq" or x_kv is None else x_kv
        return linear.apply(params[name], src, compute_dtype, quant).reshape(
            b, s, heads, d)

    n = rope_len(s)
    q = apply_rope(proj("wq", h), positions, cfg.rope_theta, n)
    k = apply_rope(proj("wk", kvh), positions, cfg.rope_theta, n)
    out = _attend_chunked(q, k, proj("wv", kvh), positions, positions, cfg)
    return linear.apply(params["wo"], out.reshape(b, s, h * d),
                        compute_dtype, quant)


def rope_len(n: int) -> int:
    """RoPE table length for positions below ``n``, rounded up to a
    multiple of 1,024 so that prompts of many lengths share a few
    tables (a table's rows do not depend on its length)."""
    return -(-n // 1024) * 1024


# ---------------------------------------------------------------------------
# the contiguous cache: dense prefill and fixed-slot decode
# ---------------------------------------------------------------------------


def cache_len(cfg: AttnConfig, max_seq: int) -> int:
    if cfg.no_ring:
        return max_seq
    return min(cfg.window, max_seq) if cfg.window else max_seq


def init_cache(batch: int, max_seq: int, cfg: AttnConfig,
               quant: QuantConfig, device) -> dict:
    """An empty (ring-buffer) cache: a pool's storage leaves with leading
    dims (batch, cache_len) and ``kpos`` (cache_len,) int32 at -1."""
    t = cache_len(cfg, max_seq)
    cache = init_paged_pool(batch, t, cfg, quant, device)
    cache["kpos"] = torch.full((t,), -1, dtype=torch.int32, device=device)
    return cache


def _write_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 slot: int, pos: int, quant: QuantConfig,
                 cfg: AttnConfig) -> None:
    """Write one token's K/V (B, 1, KVH, D) at ring slot ``slot`` (in
    place) and record its position."""
    if "k" in cache:
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    else:
        kq, vq = _quantize_kv_token(k_new, v_new, cfg, quant)
        for name, mx in (("k", kq), ("v", vq)):
            elems = cache[f"{name}_elems"]
            elems[:, slot] = mx.elements[:, 0].view(elems.dtype)
            cache[f"{name}_scales"][:, slot] = mx.scales[:, 0]
    cache["kpos"][slot] = pos


def cache_kv_view(k: torch.Tensor, v: torch.Tensor, cfg: AttnConfig,
                  quant: QuantConfig) -> tuple:
    """K/V exactly as the cache will hold them: the identity for a wide
    cache, the quantize-then-dequantize snap of the cache's own write and
    read pair (:func:`_quantize_kv_token`, :func:`_read_cache`) for an MX
    one."""
    if not _mx_cache(quant):
        return k, v
    kq, vq = _quantize_kv_token(k, v, cfg, quant)
    view = {"k_elems": kq.elements, "k_scales": kq.scales,
            "v_elems": vq.elements, "v_scales": vq.scales}
    return _read_cache(view, quant, cfg, k.dtype)


def gather_page_kv(pool: dict, page_ids: torch.Tensor, cfg: AttnConfig,
                   quant: QuantConfig, dtype=torch.bfloat16) -> tuple:
    """Dequantized K/V of pool pages ``page_ids`` in table order, each
    (1, n * PS, KVH, D): row t is absolute position t of the cached
    prefix (the tail prefill's read of shared pages)."""
    view = {key: leaf[page_ids.long()].reshape(1, -1, *leaf.shape[2:])
            for key, leaf in pool.items()}
    return _read_cache(view, quant, cfg, dtype)


def apply_decode(params, x: torch.Tensor, cache: dict, pos: int,
                 cfg: AttnConfig, quant: QuantConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One-token decode against the contiguous cache: x (B, 1, d_model),
    ``pos`` the shared position. Writes the token's K/V at ring slot
    ``pos % T`` (``cache`` in place), then attends over the whole cache
    (empty slots masked by ``kpos``)."""
    b = x.shape[0]
    h, d = cfg.num_heads, cfg.head_dim
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_decode_qkv(params, x, posv, cfg, compute_dtype,
                                  rope_len(pos + 1))
    _write_cache(cache, k, v, pos % cache["kpos"].shape[0], pos, quant, cfg)
    kc, vc = _read_cache(cache, quant, cfg, compute_dtype)
    out = _attend(q, kc, vc, posv, cache["kpos"][None], cfg)
    return linear.apply(params["wo"], out.reshape(b, 1, h * d),
                        compute_dtype)


def prefill_cache(positions: torch.Tensor, cfg: AttnConfig,
                  quant: QuantConfig, k: torch.Tensor, v: torch.Tensor,
                  max_seq: int) -> dict:
    """A fresh cache of full-sequence K/V (B, S, KVH, D) at ``positions``
    (B, S): the last ``cache_len`` tokens, at the ring slots decode would
    give them (slot p % T: when the tail fills the ring, a roll by its
    first position)."""
    b, s = positions.shape
    t = cache_len(cfg, max_seq)
    cache = init_cache(b, max_seq, cfg, quant, k.device)
    take = min(s, t)
    shift = int(positions[0, s - take]) % t if take == t else 0
    k_tail, v_tail = k[:, s - take:], v[:, s - take:]

    def place(leaf, rows):
        leaf[:, :take] = rows
        return torch.roll(leaf, shift, dims=1) if shift else leaf

    if "k" in cache:
        cache["k"] = place(cache["k"], k_tail.to(cache["k"].dtype))
        cache["v"] = place(cache["v"], v_tail.to(cache["v"].dtype))
    else:
        kq, vq = _quantize_kv_token(k_tail, v_tail, cfg, quant)
        for name, mx in (("k", kq), ("v", vq)):
            elems = cache[f"{name}_elems"]
            cache[f"{name}_elems"] = place(elems,
                                           mx.elements.view(elems.dtype))
            cache[f"{name}_scales"] = place(cache[f"{name}_scales"],
                                            mx.scales)
    kpos = cache["kpos"]
    kpos[:take] = positions[0, s - take:].to(torch.int32)
    cache["kpos"] = torch.roll(kpos, shift) if shift else kpos
    return cache


def _page_size(pool: dict) -> int:
    return pool["k" if "k" in pool else "k_elems"].shape[1]


def _table_positions(pool: dict, page_rows: torch.Tensor,
                     posv: torch.Tensor) -> int:
    """Positions the RoPE table must hold for ``posv (B, S)``: a row's
    first position lies inside its ``page_rows`` pages, so its positions
    lie below the table's end plus S (padding columns included)."""
    return page_rows.shape[1] * _page_size(pool) + posv.shape[1]


def _write_pages(pool: dict, k: torch.Tensor, v: torch.Tensor,
                 page_rows: torch.Tensor, posv: torch.Tensor,
                 cfg: AttnConfig, quant: QuantConfig) -> None:
    """Host write of new K/V rows (B, S, KVH, D) at positions ``posv``
    (B, S): page ``p // PS``, slot ``p % PS``. Unallocated entries and
    positions past the table's extent are dropped, as the reference's
    ``mode="drop"`` scatter does (a padded final chunk can reach past
    the table); an MX pool gets ``core.quantize``'s codes (a tiered
    pool their bytes, in the hot fp8 format)."""
    ps = _page_size(pool)
    pmax = page_rows.shape[1]
    widx = (posv // ps).long()
    page = page_rows.long().gather(1, widx.clamp(0, pmax - 1))
    keep = (page >= 0) & (widx <= pmax - 1)
    pg, sl = page[keep], (posv % ps).long()[keep]
    if "k" in pool:
        pool["k"][pg, sl] = k[keep].to(pool["k"].dtype)
        pool["v"][pg, sl] = v[keep].to(pool["v"].dtype)
        return
    kq, vq = _quantize_kv_token(k[keep], v[keep], cfg, quant)
    for name, mx in (("k", kq), ("v", vq)):
        elems = pool[f"{name}_elems"]
        elems[pg, sl] = mx.elements.view(elems.dtype)
        pool[f"{name}_scales"][pg, sl] = mx.scales


def _heads_split(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, KVH, S, G, D), heads split KVH major."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d).permute(0, 2, 1, 3,
                                                     4).contiguous()


def _heads_merge(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KVH, S, G, D) -> (B, S, KVH * G * D) in ``dtype``."""
    b, kvh, s, g, d = out.shape
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, kvh * g * d).to(dtype)


def _check_split(cfg: AttnConfig, pool: dict, page_fmts) -> None:
    if cfg.decode_kernel not in ("einsum", "fused"):
        raise ValueError(f"unknown decode_kernel {cfg.decode_kernel!r}")
    if page_fmts is not None and (cfg.decode_kernel != "fused"
                                  or "k_elems" not in pool):
        raise ValueError("tiered (mixed-format) KV pools require the fused "
                         "MX decode kernel path")


def apply_verify_paged(params, x: torch.Tensor, pool: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       cfg: AttnConfig, quant: QuantConfig,
                       compute_dtype=torch.bfloat16, page_fmts=None,
                       mixed_fmts=None) -> torch.Tensor:
    """Multi-token paged verify: x (B, Tq, d_model), pos (B,).

    Each slot feeds Tq tokens at positions ``pos .. pos + Tq - 1``. All
    their K/V are written into their pages first (host side, dropped for
    unallocated entries), then every query attends over the slot's pages
    with a per-row causal mask: through ``mx_attention_verify_fused``
    (``cfg.decode_kernel == "fused"`` on an MX pool) or the einsum
    gather oracle (also every wide pool). ``pool`` is updated in place; a
    tiered pool passes ``page_fmts`` / ``mixed_fmts`` (fused only).
    """
    _check_split(cfg, pool, page_fmts)
    b, tq, _ = x.shape
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    posv = pos[:, None] + torch.arange(tq, dtype=pos.dtype,
                                       device=x.device)[None]
    q, k, v = _project_decode_qkv(params, x, posv, cfg, compute_dtype,
                                  _table_positions(pool, page_rows, posv))
    _write_pages(pool, k, v, page_rows, posv, cfg, quant)
    if cfg.decode_kernel == "fused" and "k_elems" in pool:
        out = mx_attention_verify_fused(
            _heads_split(q, kvh), pool["k_elems"], pool["k_scales"],
            pool["v_elems"], pool["v_scales"], page_rows, pos + tq,
            fmt_name=quant.fmt, block_size=min(quant.block_size, d),
            softcap=cfg.softcap, window=cfg.window, page_fmts=page_fmts,
            mixed_fmts=mixed_fmts)
        out = _heads_merge(out, compute_dtype)
    else:
        npages, ps = pool["k" if "k" in pool else "k_elems"].shape[:2]
        pmax = page_rows.shape[1]
        idx = page_rows.long().clamp(0, npages - 1)  # garbage is masked
        view = {key: leaf[idx].reshape(b, pmax * ps, *leaf.shape[2:])
                for key, leaf in pool.items()}
        kc, vc = _read_cache(view, quant, cfg, compute_dtype)
        kpos = torch.arange(pmax * ps, dtype=posv.dtype,
                            device=x.device)[None].expand(b, -1)
        out = _attend(q, kc, vc, posv, kpos, cfg).reshape(b, tq, h * d)
    return linear.apply(params["wo"], out, compute_dtype)


def apply_decode_paged(params, x: torch.Tensor, pool: dict,
                       page_rows: torch.Tensor, pos: torch.Tensor,
                       cfg: AttnConfig, quant: QuantConfig,
                       compute_dtype=torch.bfloat16, page_fmts=None,
                       mixed_fmts=None) -> torch.Tensor:
    """Per-slot decode through a page table, x (B, 1, d_model): the
    ``Tq == 1`` case of :func:`apply_verify_paged`, as in the
    reference."""
    return apply_verify_paged(params, x, pool, page_rows, pos, cfg, quant,
                              compute_dtype, page_fmts=page_fmts,
                              mixed_fmts=mixed_fmts)


def apply_prefill_chunked(params, x: torch.Tensor, pool: dict,
                          page_rows: torch.Tensor, pos: torch.Tensor,
                          num_valid: torch.Tensor, cfg: AttnConfig,
                          quant: QuantConfig, compute_dtype=torch.bfloat16,
                          page_fmts=None, mixed_fmts=None) -> torch.Tensor:
    """One chunk of paged prefill: x (B, C, d_model), pos (B,) page-aligned
    chunk starts, num_valid (B,) real tokens in the chunk.

    On an MX pool with ``decode_kernel == "fused"``,
    ``mx_attention_prefill_fused`` quantizes the chunk's K/V into its
    pages inside the kernel and attends resident pages and the chunk;
    otherwise (the einsum oracle, wide pools) it is
    :func:`apply_verify_paged` with Tq = C, whose host write also lands
    the padding rows' K/V where pages exist. ``pool`` is updated in
    place.
    """
    _check_split(cfg, pool, page_fmts)
    if not (cfg.decode_kernel == "fused" and "k_elems" in pool):
        return apply_verify_paged(params, x, pool, page_rows, pos, cfg,
                                  quant, compute_dtype)
    b, c, _ = x.shape
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    posv = pos[:, None] + torch.arange(c, dtype=pos.dtype,
                                       device=x.device)[None]
    q, k, v = _project_decode_qkv(params, x, posv, cfg, compute_dtype,
                                  _table_positions(pool, page_rows, posv))
    out, _ = mx_attention_prefill_fused(
        _heads_split(q, kvh), k.contiguous(), v.contiguous(),
        pool["k_elems"], pool["k_scales"], pool["v_elems"],
        pool["v_scales"], page_rows, pos, pos + num_valid,
        fmt_name=quant.fmt, block_size=min(quant.block_size, d),
        softcap=cfg.softcap, window=cfg.window, page_fmts=page_fmts,
        mixed_fmts=mixed_fmts)
    return linear.apply(params["wo"], _heads_merge(out, compute_dtype),
                        compute_dtype)


# ---------------------------------------------------------------------------
# the ragged step
# ---------------------------------------------------------------------------


def apply_ragged(params, x: torch.Tensor, pool: dict, page_rows: torch.Tensor,
                 row_start: torch.Tensor, seq_lens: torch.Tensor,
                 cfg: AttnConfig, quant: QuantConfig,
                 compute_dtype=torch.bfloat16, page_fmts=None,
                 mixed_fmts=None, attend=None) -> torch.Tensor:
    """One ragged engine step: x (R, W, d_model), row_start/seq_lens (R,).

    Every row feeds W token columns at positions ``row_start ..
    row_start + W - 1``, of which ``seq_lens - row_start`` are real. The
    new rows' K/V go into the kernel wide and are quantized into the
    row's pages inside it; padding columns are excluded from the write
    and their outputs ignored. ``pool`` is updated in place. A tiered
    pool passes its per-page format ids ``page_fmts`` (NP,) and the
    candidate formats ``mixed_fmts``. ``attend`` replaces the ragged
    kernel's wrapper (same arguments; the megakernel's plain version
    passes the kernel's plain version, on any device).
    """
    w = x.shape[1]
    d = cfg.head_dim
    posv = row_start[:, None] + torch.arange(w, dtype=row_start.dtype,
                                             device=x.device)[None]
    q, k, v = _project_decode_qkv(params, x, posv, cfg, compute_dtype,
                                  _table_positions(pool, page_rows, posv))
    out, _ = (attend or mx_attention_ragged_fused)(
        _heads_split(q, k.shape[2]), k.contiguous(), v.contiguous(),
        pool["k_elems"], pool["k_scales"], pool["v_elems"],
        pool["v_scales"], page_rows, row_start, seq_lens,
        fmt_name=quant.fmt, block_size=min(quant.block_size, d),
        softcap=cfg.softcap, window=cfg.window, page_fmts=page_fmts,
        mixed_fmts=mixed_fmts)
    return linear.apply(params["wo"], _heads_merge(out, compute_dtype),
                        compute_dtype)
