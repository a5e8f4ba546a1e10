"""MX page-walk attention: the ragged engine step's kernel, the split
step's decode/verify and chunked-prefill kernels, and the two-pass paged
decode.

Ports of ``repro.kernels.mx_attention``'s ``mx_attention_ragged_fused``
(the default engine step), ``mx_attention_verify_fused`` with its
``Tq == 1`` wrapper ``mx_attention_decode_fused`` (the split step's decode
and verify), and ``mx_attention_prefill_fused`` (its chunked prefill).
Each takes the reference's layouts and returns its outputs; on CUDA
tensors it launches a hand-written kernel (``csrc/mx_attention_ragged.cu``,
``csrc/mx_attention_paged.cu``, both over the page walk of
``csrc/mx_attention_walk.cuh``) and on CPU tensors it runs its ``_plain``
version, a page-by-page PyTorch version of the same algorithm. Pools are
updated in place (the reference aliases them through the ``pallas_call``).
Also the reference's exactness oracle for the decode walk,
``mx_attention_decode_paged``: ``gather_kv_pages`` copies page-table rows
into contiguous compact caches and ``mx_attention_decode`` attends over
them (both in ``csrc/mx_attention_decode.cu``); no engine path runs them.

Layouts::

  q          (R, KVH, W, G, D)  bf16 queries (RoPE'd); W is the ragged
                                width, Tq the verify window, C the chunk
  k_new      (R, W, KVH, D)     bf16 new keys (RoPE'd); k_chunk the same
  v_new      (R, W, KVH, D)     bf16 new values
  ke / ve    (NP, PS, KVH, ED)  element pools: fp8 (ED = D), packed fp4
                                uint8 (ED = D/2), or mixed-format uint8
                                rows (ED = D, a page's codes in the row
                                prefix, its format in ``page_fmts``)
  ks / vs    (NP, PS, KVH, D//k) uint8 E8M0 scale pools
  page_table (R, P) int         ragged: entries < 0 map to the trash page
                                NP - 1; verify/prefill: they clip to page 0
  row_start  (R,) int           first position this step writes
                                (chunk_start: the chunk's, page-aligned)
  seq_lens   (R,) int           resident rows including the new ones
  page_fmts  (NP,) int32        mixed pools: each page's format id
  out        (R, KVH, W, G, D)  f32
  visits     (R, KVH, 1) int32  pages each cell walked
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F
from repro_torch.core import host_math

from . import build
from .mx_quantize import quantize_rows

NEG_INF = -2.0e38

#: shared memory an H100 block may use (bytes)
_MAX_SMEM = 232448

_libs = {}


def _library(name: str):
    """The loaded ``mx_attention_ragged``, ``mx_attention_paged`` or
    ``mx_attention_decode`` library with its C signatures set."""
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "mx_attention_ragged":
            lib.mx_attention_ragged_launch.argtypes = (
                [ptr] * 13 + [i32] * 15 + [f32, f32, ptr])
            lib.mx_attention_ragged_launch.restype = i32
            lib.mx_attention_ragged_smem_bytes.argtypes = [i32] * 4
            lib.mx_attention_ragged_smem_bytes.restype = ctypes.c_size_t
        elif name == "mx_attention_decode":
            lib.gather_kv_pages_launch.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
            lib.gather_kv_pages_launch.restype = i32
            lib.mx_attention_decode_launch.argtypes = (
                [ptr, i32] + [ptr] * 9 + [i32] * 10 + [f32, f32, ptr])
            lib.mx_attention_decode_launch.restype = i32
            lib.mx_attention_decode_smem_bytes.argtypes = [i32] * 3
            lib.mx_attention_decode_smem_bytes.restype = ctypes.c_size_t
        else:
            lib.mx_attention_verify_launch.argtypes = (
                [ptr] * 10 + [i32] * 13 + [f32, f32, ptr])
            lib.mx_attention_verify_launch.restype = i32
            lib.mx_attention_prefill_launch.argtypes = (
                [ptr] * 13 + [i32] * 14 + [f32, f32, ptr])
            lib.mx_attention_prefill_launch.restype = i32
            lib.mx_attention_paged_smem_bytes.argtypes = [i32] * 3
            lib.mx_attention_paged_smem_bytes.restype = ctypes.c_size_t
        _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# shared math of the plain version (the kernel's device functions mirror it)
# ---------------------------------------------------------------------------


def _dequant_rows(elems: torch.Tensor, scales: torch.Tensor,
                  fmt: F.ElementFormat, block_size: int) -> torch.Tensor:
    """Stored bytes (..., ED) + E8M0 (..., D//k) -> f32 (..., D)."""
    return F.dequantize_blocks(elems.view(fmt.storage_dtype), scales, fmt,
                               block_size)


# ---------------------------------------------------------------------------
# mixed-format (tiered) pools: full-width uint8 rows, per-page format id
# ---------------------------------------------------------------------------

#: the repack ladder (hot -> cold); the default candidate formats of a
#: mixed pool
MIXED_FMTS_DEFAULT = ("fp8_e4m3", "fp6_e3m2", "fp4_e2m1")


def _check_fmt(elems: torch.Tensor, fmt_name: str, mixed: bool = False):
    """Fail loudly when ``fmt_name`` contradicts the storage dtype (the
    reference's check): mixed pools store raw uint8 bytes, uniform fp8
    pools an fp8 dtype and packed sub-byte pools uint8."""
    if mixed:
        if elems.dtype != torch.uint8:
            raise ValueError(
                "mixed-format (tiered) pools must store raw uint8 bytes, "
                f"got {elems.dtype}")
        return
    if (elems.dtype == torch.uint8) != F.get_format(fmt_name).sub_byte:
        raise ValueError(
            f"fmt_name {fmt_name!r} does not match the cache storage dtype "
            f"{elems.dtype} (packed fp4/fp6 pools need a sub-byte fmt_name, "
            "fp8 pools an fp8 format)")


def _decode_u8_codes(codes: torch.Tensor, ebits: int,
                     mant: int) -> torch.Tensor:
    """Arithmetic decode of byte-stored fp8 codes (sign/exp/mant fields),
    as on mixed pools; equal to the fp8 cast except on the NaN/inf codes,
    which the encoders never write."""
    bias = 2 ** (ebits - 1) - 1
    c = codes.to(torch.int32)
    e = (c >> mant) & ((1 << ebits) - 1)
    m = (c & ((1 << mant) - 1)).to(torch.float32)
    scale = ((e - bias + 127) << 23).view(torch.float32)
    mag = torch.where(e == 0, m * 2.0 ** (1 - bias - mant),
                      scale * (1.0 + m * 2.0 ** -mant))
    return torch.where((c & 0x80) != 0, -mag, mag)


def _decode_bytes_as(rows: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Decode (..., D) full-width uint8 rows as ``fmt_name``: the codes
    fill the row prefix (fp8 D bytes, fp6 3D/4, fp4 D/2), the tail is
    dead. Returns (..., D) f32."""
    fmt = F.get_format(fmt_name)
    prefix = rows[..., :fmt.storage_len(rows.shape[-1])]
    if fmt.sub_byte:
        return F.decode_elements(prefix, fmt)
    return _decode_u8_codes(prefix, fmt.exp_bits, fmt.mantissa_bits)


def _mixed_fmt_name(fmt_id: int, mixed_fmts) -> str:
    """The candidate a page's id selects: the reference's select chain
    starts from the first candidate and takes the one whose id matches,
    so an id outside ``mixed_fmts`` decodes as ``mixed_fmts[0]``."""
    name = mixed_fmts[0]
    for cand in mixed_fmts:
        if F.FORMAT_IDS[cand] == fmt_id:
            name = cand
    return name


def _dequant_rows_mixed(rows: torch.Tensor, scales: torch.Tensor,
                        fmt_id: int, mixed_fmts,
                        block_size: int) -> torch.Tensor:
    """(..., D) uint8 rows + E8M0 scales + the page's format id -> f32:
    decode, fold the scales, flush subnormal results."""
    vals = _decode_bytes_as(rows, _mixed_fmt_name(fmt_id, mixed_fmts))
    blocked = vals.reshape(*vals.shape[:-1], scales.shape[-1], block_size)
    wide = blocked * F.e8m0_factor(scales)[..., None]
    return F.flush_subnormals(wide).reshape(vals.shape)


def _first_window_page(qpos_min: int, window, page_size: int) -> int:
    """First page any query of the row can see under a sliding window."""
    if window is None:
        return 0
    return max((qpos_min - window + 1) // page_size, 0)


def _flash_update(state, q, k, v, mask, softcap, scale: float):
    """One online-softmax step over a page tile, as the reference's
    ``_flash_update``: q (KVH, rows, D), k/v (KVH, PS, D), mask (rows, PS)."""
    m, l, acc = state
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if softcap:
        s = host_math.softcap(s, softcap)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    probs = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
    l = l * alpha + probs.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(probs, v)
    return m_new, l, acc


# ---------------------------------------------------------------------------
# plain versions: the page walk of one row, as the kernels' shared walk
# ---------------------------------------------------------------------------


def _tile_reader(pools, fmt_name: str, block_size: int, page_fmts,
                 mixed_fmts):
    """``read(page, as_fmt=None) -> (K, V)`` (KVH, PS, D) f32 tiles of a
    pool page: under the pool's format, a mixed page's own id, or (a
    chunk page of a mixed pool) the hot format ``as_fmt``."""
    ke, ks, ve, vs = pools
    fmt = F.get_format(fmt_name)
    fmt_ids = None if page_fmts is None else page_fmts.tolist()

    def one(elems, scales, page, as_fmt):
        if fmt_ids is None:
            tile = _dequant_rows(elems[page], scales[page], fmt, block_size)
        elif as_fmt is not None:
            tile = _dequant_rows_mixed(elems[page], scales[page],
                                       F.FORMAT_IDS[as_fmt], (as_fmt,),
                                       block_size)
        else:
            tile = _dequant_rows_mixed(elems[page], scales[page],
                                       fmt_ids[page], mixed_fmts, block_size)
        return tile.transpose(0, 1)

    def read(page, as_fmt=None):
        return one(ke, ks, page, as_fmt), one(ve, vs, page, as_fmt)
    return read


def _walk_row(qf, qpos, pages, tile, page_size: int, window, softcap,
              scale: float):
    """One row's online softmax over ``pages`` (walk order): ``qf`` (KVH,
    rows, D) f32, ``qpos`` (rows,) each query row's position, ``tile(p)``
    the page's (K, V) tiles. Returns (KVH, rows, D) f32 acc / l."""
    kvh, rows, d = qf.shape
    dev = qf.device
    page_rows = torch.arange(page_size, device=dev)
    state = (torch.full((kvh, rows, 1), NEG_INF, device=dev),
             torch.zeros((kvh, rows, 1), device=dev),
             torch.zeros((kvh, rows, d), device=dev))
    for p in pages:
        kt, vt = tile(p)
        kpos = p * page_size + page_rows
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        state = _flash_update(state, qf, kt, vt, mask, softcap, scale)
    _, l, acc = state
    return acc / l


def _plain_setup(q, ke):
    r, kvh, n, g, d = q.shape
    out = torch.empty((r, kvh, n * g, d), dtype=torch.float32,
                      device=q.device)
    visits = torch.zeros((r, kvh, 1), dtype=torch.int32, device=q.device)
    q_idx = torch.arange(n * g, device=q.device) // g
    return out, visits, q_idx, ke.shape[1], d ** -0.5


def mx_attention_ragged_fused_plain(q, k_new, v_new, ke, ks, ve, vs, table,
                                    row_start, seq_lens, *,
                                    fmt_name: str, block_size: int,
                                    softcap=None, window=None,
                                    page_fmts=None, mixed_fmts=None):
    """Page-by-page PyTorch version of the ragged kernel, same layouts.

    Expects the rows normalised by :func:`normalize_rows`. Rows run in
    order and, within a row, each page of the write window is merged
    before it is attended, as the reference's sequential grid does. The
    pools are updated in place. With ``page_fmts`` the pools are mixed:
    new rows land as ``fmt_name`` (an fp8) bytes, and every page decodes
    under its own format id. Returns ``(out, visits)``.
    """
    fmt = F.get_format(fmt_name)
    r, kvh, w, g, d = q.shape
    out, visits, q_idx, ps, scale = _plain_setup(q, ke)
    pmax = table.shape[1]
    pools = [p.view(torch.uint8) for p in (ke, ks, ve, vs)]
    read = _tile_reader(pools, fmt_name, block_size, page_fmts, mixed_fmts)
    tbl = table.tolist()
    page_rows = torch.arange(ps, device=q.device)
    for i, (start, seq_len) in enumerate(zip(row_start.tolist(),
                                             seq_lens.tolist())):
        w0 = start // ps
        valid = min(-(-seq_len // ps), pmax)
        first = _first_window_page(start, window, ps)

        def tile(p):
            page = tbl[i][p]
            if p >= w0:
                # write window: new row t lands on page row j where
                # start + t == p * PS + j; other rows keep their bytes (a
                # page row is one token's whole row, so the merge never
                # splits a packed byte)
                kpos = p * ps + page_rows
                sel = ((kpos >= start) & (kpos < seq_len)).nonzero()[:, 0]
                t = kpos[sel] - start
                for new, elems, scales in ((k_new, pools[0], pools[1]),
                                           (v_new, pools[2], pools[3])):
                    # -0.0 (and flushed subnormals) -> +0.0, as the
                    # reference's one-hot f32 gather of the new rows does
                    x = F.flush_subnormals(new[i, t].to(torch.float32))
                    x = torch.where(x == 0, torch.zeros_like(x), x)
                    codes, e = quantize_rows(x, fmt, block_size)
                    elems[page, sel] = codes
                    scales[page, sel] = e
            return read(page)

        # padding queries (t >= n_new) clamp onto the last real position
        qpos = start + torch.clamp(q_idx, max=seq_len - start - 1)
        qf = q[i].reshape(kvh, w * g, d).to(torch.float32)
        out[i] = _walk_row(qf, qpos, range(first, valid), tile, ps, window,
                           softcap, scale)
        visits[i] = max(0, valid - first)
    return out.reshape(r, kvh, w, g, d), visits


def mx_attention_verify_fused_plain(q, ke, ks, ve, vs, table, seq_lens, *,
                                    fmt_name: str, block_size: int,
                                    softcap=None, window=None,
                                    page_fmts=None, mixed_fmts=None):
    """PyTorch version of the decode/verify kernel, same layouts.

    Expects the table and lengths normalised by
    :func:`normalize_verify`. Query ``t`` of a row sits at ``seq_len -
    Tq + t`` and sees keys up to its own position; nothing is written.
    Returns ``(out, visits)``.
    """
    r, kvh, tq, g, d = q.shape
    out, visits, q_idx, ps, scale = _plain_setup(q, ke)
    pmax = table.shape[1]
    read = _tile_reader([p.view(torch.uint8) for p in (ke, ks, ve, vs)],
                        fmt_name, block_size, page_fmts, mixed_fmts)
    tbl = table.tolist()
    for i, seq_len in enumerate(seq_lens.tolist()):
        valid = min(-(-seq_len // ps), pmax)
        first = _first_window_page(seq_len - tq, window, ps)
        qf = q[i].reshape(kvh, tq * g, d).to(torch.float32)
        out[i] = _walk_row(qf, seq_len - tq + q_idx, range(first, valid),
                           lambda p: read(tbl[i][p]), ps, window, softcap,
                           scale)
        visits[i] = max(0, valid - first)
    return out.reshape(r, kvh, tq, g, d), visits


def mx_attention_prefill_fused_plain(q, k_chunk, v_chunk, ke, ks, ve, vs,
                                     table, chunk_start, seq_lens, *,
                                     fmt_name: str, block_size: int,
                                     softcap=None, window=None,
                                     page_fmts=None, mixed_fmts=None):
    """PyTorch version of the chunked-prefill kernel, same layouts.

    Expects the rows normalised by :func:`normalize_prefill`. Rows run in
    order. A row first quantizes the whole (PS, D) tile of each of its
    chunk pages ``[start / PS, ceil(seq_len / PS))`` from the wide chunk,
    padding rows included, with the signs of zeros kept (no one-hot
    gather here), and writes codes and scales into the pools in place;
    then it walks its resident pages under their formats and its chunk
    pages under ``fmt_name``. Query ``t`` sits at ``start + t``. Returns
    ``(out, visits)``.
    """
    fmt = F.get_format(fmt_name)
    r, kvh, c, g, d = q.shape
    out, visits, q_idx, ps, scale = _plain_setup(q, ke)
    pmax = table.shape[1]
    pools = [p.view(torch.uint8) for p in (ke, ks, ve, vs)]
    read = _tile_reader(pools, fmt_name, block_size, page_fmts, mixed_fmts)
    hot = fmt_name if page_fmts is not None else None
    tbl = table.tolist()
    for i, (start, seq_len) in enumerate(zip(chunk_start.tolist(),
                                             seq_lens.tolist())):
        c0 = start // ps
        valid = min(-(-seq_len // ps), pmax)
        first = _first_window_page(start, window, ps)
        for p in range(c0, valid):
            rows = slice((p - c0) * ps, (p - c0 + 1) * ps)
            for wide, elems, scales in ((k_chunk, pools[0], pools[1]),
                                        (v_chunk, pools[2], pools[3])):
                codes, e = quantize_rows(wide[i, rows].to(torch.float32),
                                         fmt, block_size)
                elems[tbl[i][p]] = codes
                scales[tbl[i][p]] = e
        qf = q[i].reshape(kvh, c * g, d).to(torch.float32)
        out[i] = _walk_row(
            qf, start + q_idx, range(first, valid),
            lambda p: read(tbl[i][p], None if p < c0 else hot), ps, window,
            softcap, scale)
        visits[i] = max(0, min(c0, valid) - first) + max(0, valid - c0)
    return out.reshape(r, kvh, c, g, d), visits


# ---------------------------------------------------------------------------
# the reference wrappers' argument normalisation
# ---------------------------------------------------------------------------


def normalize_rows(page_table, row_start, seq_lens, num_pages: int,
                   width: int):
    """The ragged wrapper's row metadata normalisation: negative table
    entries -> the trash page ``num_pages - 1``, live entries clamped into
    the pool, ``seq_lens`` clamped to ``[row_start + 1, row_start + W]``.
    Returns contiguous int32 ``(table, row_start, seq_lens)``."""
    table = page_table.to(torch.int32)
    table = torch.where(table < 0, torch.full_like(table, num_pages - 1),
                        table.clamp(0, num_pages - 1)).contiguous()
    start = row_start.to(torch.int32).contiguous()
    lens = torch.minimum(torch.maximum(seq_lens.to(torch.int32), start + 1),
                         start + width).contiguous()
    return table, start, lens


def normalize_verify(page_table, seq_lens, num_pages: int, tq: int):
    """The verify wrapper's: table entries clipped into ``[0, NP)`` (so
    unallocated entries read page 0, not a trash page), ``seq_lens``
    raised to at least ``Tq`` (an inactive slot walks page 0). Returns
    contiguous int32 ``(table, seq_lens)``."""
    table = page_table.to(torch.int32).clamp(0, num_pages - 1).contiguous()
    lens = torch.clamp(seq_lens.to(torch.int32), min=tq).contiguous()
    return table, lens


def normalize_prefill(page_table, chunk_start, seq_lens, num_pages: int,
                      chunk: int):
    """The prefill wrapper's: table entries clipped into ``[0, NP)``,
    ``seq_lens`` clamped to ``[start + 1, start + C]`` (at least one real
    token per chunk, at most the whole chunk). Returns contiguous int32
    ``(table, chunk_start, seq_lens)``."""
    table = page_table.to(torch.int32).clamp(0, num_pages - 1).contiguous()
    start = chunk_start.to(torch.int32).contiguous()
    lens = torch.minimum(torch.maximum(seq_lens.to(torch.int32), start + 1),
                         start + chunk).contiguous()
    return table, start, lens


def _check_pools(q, ke, ks, ve, vs, fmt_name: str, block_size: int,
                 page_fmts, mixed_fmts, what: str):
    """The wrappers' shared checks of q (R, KVH, n, G, D) against the
    pools; returns ``(fmt, mixed_fmts)`` with the mixed default filled."""
    return _check_pool_shapes(q.shape[1], q.shape[-1], ke, ks, ve, vs,
                              fmt_name, block_size, page_fmts, mixed_fmts,
                              what)


def _check_pool_shapes(kvh: int, d: int, ke, ks, ve, vs, fmt_name: str,
                       block_size: int, page_fmts, mixed_fmts, what: str):
    """One layer's pools against ``kvh`` heads of ``d``; returns ``(fmt,
    mixed_fmts)`` with the mixed default filled."""
    fmt = F.get_format(fmt_name)
    mixed = page_fmts is not None
    _check_fmt(ke, fmt_name, mixed=mixed)
    _check_fmt(ve, fmt_name, mixed=mixed)
    npages, ps = ke.shape[:2]
    if mixed:
        mixed_fmts = tuple(mixed_fmts or MIXED_FMTS_DEFAULT)
        if fmt.bits != 8:
            raise ValueError(
                f"tiered {what} write pages in the hot format, which must "
                f"be an fp8; got {fmt_name!r}")
        if page_fmts.shape != (npages,) or page_fmts.dtype != torch.int32:
            raise ValueError(f"page_fmts must be ({npages},) int32")
        ed = d
    else:
        mixed_fmts = None
        if fmt.bits == 6:
            raise ValueError(
                "uniform fp6 pools have no layout: the reference allocates "
                "D-byte rows for them but writes 3D/4 packed bytes (fp6 "
                "reaches a pool only as a tier of a mixed pool)")
        ed = fmt.storage_len(d)
    for name, pool in (("ks", ks), ("vs", vs)):
        if pool.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 E8M0 bytes")
    if ke.shape != (npages, ps, kvh, ed) or ve.shape != ke.shape:
        raise ValueError(f"element pools must be (NP, PS, {kvh}, {ed})")
    if ks.shape != (npages, ps, kvh, d // block_size) or vs.shape != ks.shape:
        raise ValueError(f"scale pools must be (NP, PS, {kvh}, "
                         f"{d // block_size})")
    if d % block_size:
        raise ValueError(f"block_size {block_size} must divide {d}")
    return fmt, mixed_fmts


def _check_meta(r: int, page_table, *vectors, window=None):
    if page_table.ndim != 2 or page_table.shape[0] != r \
            or any(v.shape != (r,) for v in vectors):
        raise ValueError(f"page_table must be ({r}, P) and the row "
                         f"vectors ({r},)")
    if any(t.is_floating_point() for t in (page_table, *vectors)):
        raise ValueError("page tables and row vectors are integers")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _on_one_device(dev, *tensors):
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no attention kernel for device {dev}")


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def query_tile(w: int, g: int, d: int, ps: int, smem_bytes,
               budget: int = _MAX_SMEM) -> int:
    """Tokens of the query tile in which a cell walks its ``w * g`` query
    rows (the ragged cell of #1 and #8's phase B over ``w`` tokens, #3's
    cell over a chunk of ``w``): ``w`` when the whole cell's walk fits
    ``budget`` bytes of shared memory, else the largest multiple of 16
    tokens whose walk does. ``smem_bytes(t, g, d, ps)`` is the library's
    size of a tile of ``t`` tokens (the ragged library's
    ``mx_attention_ragged_smem_bytes``, the megakernel's
    ``mx_megakernel_smem_bytes``, :func:`_paged_tile_bytes`). At W 256
    that is 64 tokens at granite-8b (G 4, D 128) and gemma2-9b (G 2, D
    256), 80 at phi4-mini (G 3, D 128); at W or C 64, 32 at mixtral-8x22b
    (G 6, D 128). Raises ``NotImplementedError`` when not even 16 tokens
    fit."""
    if smem_bytes(w, g, d, ps) <= budget:
        return w
    t = (w - 1) // 16 * 16
    while t >= 16 and smem_bytes(t, g, d, ps) > budget:
        t -= 16
    if t < 16:
        raise NotImplementedError(
            f"16 tokens x {g} query rows of head_dim {d} need "
            f"{smem_bytes(16, g, d, ps)} bytes of shared memory per CTA; an "
            f"H100 block has {budget}")
    return t


def _paged_tile_bytes(lib):
    """The paged library's walk size as ``query_tile`` asks for it."""
    return lambda t, g, d, ps: lib.mx_attention_paged_smem_bytes(
        t * g, d, ps)


def _check_tile(tile_tokens) -> None:
    if tile_tokens is not None and (isinstance(tile_tokens, bool)
                                    or not isinstance(tile_tokens, int)
                                    or tile_tokens < 1):
        raise ValueError(f"tile_tokens must be a positive int, got "
                         f"{tile_tokens!r}")


def _launch_common(wide, pools, ps: int, d: int, block: int, smem: int,
                   rows: int):
    """Checks every launch shares; raises on what the kernels do not take.
    ``wide`` and ``pools`` are (name, tensor) pairs: the bf16 operands and
    the rest; ``smem`` the bytes a CTA's walk of ``rows`` query rows (a
    query tile's, for the ragged cell) needs."""
    for name, t in wide:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA attention kernels take bf16 {name}, "
                            f"got {t.dtype}")
    for name, t in wide + pools:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the walk's tile (csrc/mx_attention_walk.cuh): 16-wide steps over the
    # head dim, keys padded to 16 or 32, 4-element decode groups, a warp
    # for each block of the page writes
    if not 0 < ps <= 32:
        raise ValueError("the CUDA attention kernels take page_size <= 32")
    if d % 16 or not 0 < d <= 256:
        raise ValueError(f"head_dim {d}: the CUDA attention kernels take a "
                         "multiple of 16 up to 256")
    if block % 4 or not 0 < block <= 32:
        raise ValueError(f"block_size {block}: the CUDA attention kernels "
                         "take a multiple of 4 up to 32 (a warp a block)")
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"{rows} query rows x head_dim {d} need {smem} bytes of shared "
            f"memory per CTA; an H100 block has {_MAX_SMEM}")


def _mixed_ids(page_fmts, mixed_fmts):
    """(candidate id mask, default id) of a mixed pool; (0, 0) uniform."""
    if page_fmts is None:
        return 0, 0
    mask = 0
    for name in mixed_fmts:
        mask |= 1 << F.FORMAT_IDS[name]
    return mask, F.FORMAT_IDS[mixed_fmts[0]]


def _tail_args(fmt_name, block_size, window, page_fmts, mixed_fmts,
               softcap, d, device):
    mask, default = _mixed_ids(page_fmts, mixed_fmts)
    return (block_size, F.FORMAT_IDS[fmt_name],
            -1 if window is None else int(window), mask, default,
            float(softcap or 0.0), float(d ** -0.5),
            torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k_new, v_new, ke, ks, ve, vs, table, start, lens, *,
            fmt_name, block_size, softcap, window, page_fmts, mixed_fmts,
            tile_tokens):
    r, kvh, w, g, d = q.shape
    ps, ed = ke.shape[1], ke.shape[-1]
    lib = _library("mx_attention_ragged")
    smem_bytes = lib.mx_attention_ragged_smem_bytes
    tile = min(tile_tokens or query_tile(w, g, d, ps, smem_bytes), w)
    _launch_common([("q", q), ("k_new", k_new), ("v_new", v_new)],
                   [("ke", ke), ("ks", ks), ("ve", ve), ("vs", vs),
                    ("page_fmts", page_fmts)], ps, d, block_size,
                   smem_bytes(tile, g, d, ps), tile * g)
    out = torch.empty((r, kvh, w, g, d), dtype=torch.float32,
                      device=q.device)
    visits = torch.empty((r, kvh, 1), dtype=torch.int32, device=q.device)
    err = lib.mx_attention_ragged_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ke.data_ptr(),
        ks.data_ptr(), ve.data_ptr(), vs.data_ptr(), table.data_ptr(),
        start.data_ptr(), lens.data_ptr(), _ptr(page_fmts), out.data_ptr(),
        visits.data_ptr(), r, kvh, w, g, d, ed, ps, table.shape[1],
        ke.shape[0], tile,
        *_tail_args(fmt_name, block_size, window, page_fmts, mixed_fmts,
                    softcap, d, q.device))
    if err != 0:
        raise RuntimeError(f"mx_attention_ragged_launch failed: cudaError "
                           f"{err}")
    mx_attention_ragged_fused.launches += 1
    return out, visits


def _launch_verify(q, ke, ks, ve, vs, table, lens, *, fmt_name, block_size,
                   softcap, window, page_fmts, mixed_fmts):
    b, kvh, tq, g, d = q.shape
    ps, ed = ke.shape[1], ke.shape[-1]
    lib = _library("mx_attention_paged")
    _launch_common([("q", q)],
                   [("ke", ke), ("ks", ks), ("ve", ve), ("vs", vs),
                    ("page_fmts", page_fmts)], ps, d, block_size,
                   lib.mx_attention_paged_smem_bytes(tq * g, d, ps), tq * g)
    out = torch.empty((b, kvh, tq, g, d), dtype=torch.float32,
                      device=q.device)
    visits = torch.empty((b, kvh, 1), dtype=torch.int32, device=q.device)
    err = lib.mx_attention_verify_launch(
        q.data_ptr(), ke.data_ptr(), ks.data_ptr(), ve.data_ptr(),
        vs.data_ptr(), table.data_ptr(), lens.data_ptr(), _ptr(page_fmts),
        out.data_ptr(), visits.data_ptr(), b, kvh, tq, g, d, ed, ps,
        table.shape[1],
        *_tail_args(fmt_name, block_size, window, page_fmts, mixed_fmts,
                    softcap, d, q.device))
    if err != 0:
        raise RuntimeError(f"mx_attention_verify_launch failed: cudaError "
                           f"{err}")
    mx_attention_verify_fused.launches += 1
    return out, visits


def _launch_prefill(q, k_chunk, v_chunk, ke, ks, ve, vs, table, start, lens,
                    *, fmt_name, block_size, softcap, window, page_fmts,
                    mixed_fmts, tile_tokens):
    b, kvh, c, g, d = q.shape
    ps, ed = ke.shape[1], ke.shape[-1]
    lib = _library("mx_attention_paged")
    smem_bytes = _paged_tile_bytes(lib)
    tile = min(tile_tokens or query_tile(c, g, d, ps, smem_bytes), c)
    _launch_common([("q", q), ("k_chunk", k_chunk), ("v_chunk", v_chunk)],
                   [("ke", ke), ("ks", ks), ("ve", ve), ("vs", vs),
                    ("page_fmts", page_fmts)], ps, d, block_size,
                   smem_bytes(tile, g, d, ps), tile * g)
    out = torch.empty((b, kvh, c, g, d), dtype=torch.float32,
                      device=q.device)
    visits = torch.empty((b, kvh, 1), dtype=torch.int32, device=q.device)
    err = lib.mx_attention_prefill_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), ke.data_ptr(),
        ks.data_ptr(), ve.data_ptr(), vs.data_ptr(), table.data_ptr(),
        start.data_ptr(), lens.data_ptr(), _ptr(page_fmts), out.data_ptr(),
        visits.data_ptr(), b, kvh, c, g, d, ed, ps, table.shape[1], tile,
        *_tail_args(fmt_name, block_size, window, page_fmts, mixed_fmts,
                    softcap, d, q.device))
    if err != 0:
        raise RuntimeError(f"mx_attention_prefill_launch failed: cudaError "
                           f"{err}")
    mx_attention_prefill_fused.launches += 1
    return out, visits


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def mx_attention_ragged_fused(q, k_new, v_new, ke, ks, ve, vs, page_table,
                              row_start, seq_lens, *,
                              fmt_name: str = "fp8_e4m3",
                              block_size: int = 32, softcap=None,
                              window=None, page_fmts=None, mixed_fmts=None,
                              debug_visits: bool = False,
                              tile_tokens=None):
    """One ragged engine step over the MX page pool (layouts above).

    Returns ``(out, (ke, ks, ve, vs))``, plus ``visits`` with
    ``debug_visits=True``; the pools are the inputs, updated in place.
    Pools are uniform fp8, uniform packed fp4, or, with ``page_fmts``
    ((NP,) int32 format ids; ``mixed_fmts`` the candidate formats,
    default :data:`MIXED_FMTS_DEFAULT`), mixed-format uint8 rows whose
    write-window pages the caller guarantees are in ``fmt_name``, an
    fp8 (the tiered engine's hot-write invariant; nothing here fixes a
    page that breaks it). Uniform fp6 pools raise ``ValueError``: the
    reference has no layout for them (it allocates D-byte rows but
    writes 3D/4 packed bytes). CUDA tensors launch the CUDA kernel (and
    count it in ``mx_attention_ragged_fused.launches``); CPU tensors run
    the plain version. Negative table entries map to the trash page
    NP - 1, live entries clamp into the pool, and ``seq_lens`` clamps to
    ``[row_start + 1, row_start + W]``, as in the reference's wrapper.
    The kernel walks a cell's ``W * G`` query rows in tiles of
    ``tile_tokens`` tokens (None: :func:`query_tile`'s choice, the whole
    cell where it fits); a smaller tile gives the same bits, so a check
    can force several tiles where one fits. The plain version has no
    tiles and only checks it.
    """
    _check_tile(tile_tokens)
    fmt, mixed_fmts = _check_pools(q, ke, ks, ve, vs, fmt_name, block_size,
                                   page_fmts, mixed_fmts, "ragged steps")
    r, kvh, w, g, d = q.shape
    if k_new.shape != (r, w, kvh, d) or v_new.shape != (r, w, kvh, d):
        raise ValueError(f"k_new/v_new must be {(r, w, kvh, d)}")
    _check_meta(r, page_table, row_start, seq_lens, window=window)
    dev = q.device
    _on_one_device(dev, k_new, v_new, ke, ks, ve, vs, page_table, row_start,
                   seq_lens, page_fmts)
    kw = dict(fmt_name=fmt.name, block_size=block_size, softcap=softcap,
              window=window, page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    if dev.type == "cuda":
        # the kernel's cell applies normalize_rows' map itself
        out, visits = _launch(q, k_new, v_new, ke, ks, ve, vs, *(
            t.to(torch.int32).contiguous()
            for t in (page_table, row_start, seq_lens)),
            tile_tokens=tile_tokens, **kw)
    else:
        table, start, lens = normalize_rows(page_table, row_start, seq_lens,
                                            ke.shape[0], w)
        out, visits = mx_attention_ragged_fused_plain(
            q, k_new, v_new, ke, ks, ve, vs, table, start, lens, **kw)
    pools = (ke, ks, ve, vs)
    return (out, pools, visits) if debug_visits else (out, pools)


def mx_attention_verify_fused(q, ke, ks, ve, vs, page_table, seq_lens, *,
                              fmt_name: str = "fp8_e4m3",
                              block_size: int = 32, softcap=None,
                              window=None, page_fmts=None, mixed_fmts=None,
                              debug_visits: bool = False):
    """Read-only page walk for ``Tq >= 1`` queries per slot (layouts
    above, ``q`` (B, KVH, Tq, G, D)): the split step's decode and
    speculative verify, after the host wrote the step's K/V.

    Query ``t`` sits at ``seq_len - Tq + t`` and sees keys up to its own
    position (and inside ``window``). Table entries clip into ``[0, NP)``
    (unallocated ones read page 0) and ``seq_lens`` is raised to at
    least ``Tq``, as in the reference's wrapper, so an inactive slot
    walks page 0: its output is garbage the caller ignores, and it
    counts one visit. Returns ``out`` (B, KVH, Tq, G, D) f32, plus
    ``visits`` (B, KVH, 1) with ``debug_visits=True``. Pools as in
    :func:`mx_attention_ragged_fused`. CUDA tensors launch the CUDA
    kernel (counted in ``mx_attention_verify_fused.launches``); CPU
    tensors run :func:`mx_attention_verify_fused_plain`.
    """
    fmt, mixed_fmts = _check_pools(q, ke, ks, ve, vs, fmt_name, block_size,
                                   page_fmts, mixed_fmts, "verify walks")
    b, _, tq = q.shape[:3]
    _check_meta(b, page_table, seq_lens, window=window)
    dev = q.device
    _on_one_device(dev, ke, ks, ve, vs, page_table, seq_lens, page_fmts)
    table, lens = normalize_verify(page_table, seq_lens, ke.shape[0], tq)
    kw = dict(fmt_name=fmt.name, block_size=block_size, softcap=softcap,
              window=window, page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    run = (_launch_verify if dev.type == "cuda"
           else mx_attention_verify_fused_plain)
    out, visits = run(q, ke, ks, ve, vs, table, lens, **kw)
    return (out, visits) if debug_visits else out


def mx_attention_decode_fused(q, ke, ks, ve, vs, page_table, seq_lens, *,
                              fmt_name: str = "fp8_e4m3",
                              block_size: int = 32, softcap=None,
                              window=None, page_fmts=None, mixed_fmts=None,
                              debug_visits: bool = False):
    """The ``Tq == 1`` case of :func:`mx_attention_verify_fused` (the same
    kernel and launch count): ``q`` (B, KVH, G, D), the query at
    ``seq_len - 1``. Returns ``out`` (B, KVH, G, D) f32 (and visits)."""
    res = mx_attention_verify_fused(
        q[:, :, None], ke, ks, ve, vs, page_table, seq_lens,
        fmt_name=fmt_name, block_size=block_size, softcap=softcap,
        window=window, page_fmts=page_fmts, mixed_fmts=mixed_fmts,
        debug_visits=debug_visits)
    if debug_visits:
        out, visits = res
        return out[:, :, 0], visits
    return res[:, :, 0]


def mx_attention_prefill_fused(q, k_chunk, v_chunk, ke, ks, ve, vs,
                               page_table, chunk_start, seq_lens, *,
                               fmt_name: str = "fp8_e4m3",
                               block_size: int = 32, softcap=None,
                               window=None, page_fmts=None, mixed_fmts=None,
                               debug_visits: bool = False, tile_tokens=None):
    """One page-aligned prompt chunk of ``C`` tokens per row (layouts
    above, ``q`` (B, KVH, C, G, D), ``k_chunk``/``v_chunk`` (B, C, KVH,
    D)): attend the resident pages below ``chunk_start``, quantize the
    chunk's K/V into its own pages ``[start / PS, ceil(seq_len / PS))``
    and attend them.

    ``C`` is a multiple of the page size and ``chunk_start`` page-aligned,
    so a page is wholly resident or wholly the chunk's. A chunk page is
    quantized whole, padding rows of a final chunk included, as in the
    reference; pages past ``seq_len`` are neither read nor written. With
    B > 1 rows, chunk pages must be the row's own (resident pages may be
    shared read-only). Table entries clip into ``[0, NP)`` and
    ``seq_lens`` clamps to ``[start + 1, start + C]``. A mixed pool's
    chunk pages are written in the hot format ``fmt_name`` (an fp8).
    Returns ``(out (B, KVH, C, G, D) f32, (ke, ks, ve, vs))``, plus
    ``visits`` with ``debug_visits=True``; the pools update in place.
    CUDA tensors launch the CUDA kernel (counted in
    ``mx_attention_prefill_fused.launches``); CPU tensors run
    :func:`mx_attention_prefill_fused_plain`. The kernel walks a cell's
    ``C * G`` query rows in tiles of ``tile_tokens`` tokens, as
    :func:`mx_attention_ragged_fused` does (None: :func:`query_tile`'s
    choice); any tile gives the same bits, and the plain version only
    checks it.
    """
    _check_tile(tile_tokens)
    fmt, mixed_fmts = _check_pools(q, ke, ks, ve, vs, fmt_name, block_size,
                                   page_fmts, mixed_fmts, "prefills")
    b, kvh, c, g, d = q.shape
    ps = ke.shape[1]
    if c % ps:
        raise ValueError(
            f"chunk length {c} must be a whole number of pages "
            f"(page_size={ps}): a partial chunk page would blend resident "
            "and chunk rows inside one tile")
    if k_chunk.shape != (b, c, kvh, d) or v_chunk.shape != (b, c, kvh, d):
        raise ValueError(f"k_chunk/v_chunk must be {(b, c, kvh, d)}")
    _check_meta(b, page_table, chunk_start, seq_lens, window=window)
    dev = q.device
    _on_one_device(dev, k_chunk, v_chunk, ke, ks, ve, vs, page_table,
                   chunk_start, seq_lens, page_fmts)
    table, start, lens = normalize_prefill(page_table, chunk_start, seq_lens,
                                           ke.shape[0], c)
    kw = dict(fmt_name=fmt.name, block_size=block_size, softcap=softcap,
              window=window, page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    if dev.type == "cuda":
        out, visits = _launch_prefill(q, k_chunk, v_chunk, ke, ks, ve, vs,
                                      table, start, lens,
                                      tile_tokens=tile_tokens, **kw)
    else:
        out, visits = mx_attention_prefill_fused_plain(
            q, k_chunk, v_chunk, ke, ks, ve, vs, table, start, lens, **kw)
    pools = (ke, ks, ve, vs)
    return (out, pools, visits) if debug_visits else (out, pools)


# ---------------------------------------------------------------------------
# the two-pass paged decode: page-table gather, then contiguous decode
# ---------------------------------------------------------------------------


def gather_kv_pages_plain(ke, ks, ve, vs, table):
    """PyTorch version of the gather kernel: ``(k_elems, k_scales,
    v_elems, v_scales)`` (B, KVH, P * PS, .) from the pools' pages
    ``clip(table, 0, NP - 1)``, bytes copied as they are."""
    npages, ps, kvh = ke.shape[:3]
    b, pmax = table.shape
    idx = table.long().clamp(0, npages - 1)

    def one(pool):
        rows = pool.view(torch.uint8)[idx]  # (B, P, PS, KVH, width)
        return rows.permute(0, 3, 1, 2, 4).contiguous().reshape(
            b, kvh, pmax * ps, -1).view(pool.dtype)
    return one(ke), one(ks), one(ve), one(vs)


def mx_attention_decode_plain(q, k_elems, k_scales, v_elems, v_scales, kpos,
                              pos, *, fmt_name: str, block_size: int,
                              softcap=None):
    """PyTorch version of the decode kernel, the reference's order: f32
    logits over all T keys times ``d ** -0.5`` (softcapped), masked keys
    at the finite NEG_INF, one max, ``exp(l - m)``, the sum, ``(p @ V) /
    sum``. ``kpos`` (B, T) and ``pos`` (B,) int32. One sequence at a
    time, as the kernel's cells are independent: a row's bits do not
    depend on the batch it came in (a batched CPU matmul may sum in
    another order), which the paged wrapper's bit-equality needs."""
    fmt = F.get_format(fmt_name)
    d = q.shape[-1]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        k = _dequant_rows(k_elems[i], k_scales[i], fmt, block_size)
        v = _dequant_rows(v_elems[i], v_scales[i], fmt, block_size)
        logits = torch.matmul(q[i].to(torch.float32), k.transpose(-1, -2)) \
            * d ** -0.5
        if softcap:
            logits = host_math.softcap(logits, softcap)
        mask = (kpos[i] <= pos[i]) & (kpos[i] >= 0)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        out[i] = torch.matmul(p, v) / p.sum(dim=-1, keepdim=True)
    return out


def _launch_gather(ke, ks, ve, vs, table):
    npages, ps, kvh, ed = ke.shape
    nb = ks.shape[-1]
    b, pmax = table.shape
    lib = _library("mx_attention_decode")
    for name, t in (("ke", ke), ("ks", ks), ("ve", ve), ("vs", vs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = [torch.empty((b, kvh, pmax * ps, pool.shape[-1]), dtype=pool.dtype,
                        device=ke.device) for pool in (ke, ks, ve, vs)]
    err = lib.gather_kv_pages_launch(
        ke.data_ptr(), ks.data_ptr(), ve.data_ptr(), vs.data_ptr(),
        table.data_ptr(), *(o.data_ptr() for o in outs), b, pmax, npages, ps,
        kvh, ed, nb, torch.cuda.current_stream(ke.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_kv_pages_launch failed: cudaError {err}")
    gather_kv_pages.launches += 1
    return tuple(outs)


#: keys a split of the CUDA decode takes: of 16-64, the fastest at B 8
#: (granite's 21 and 64 pages) and within 12% of the fastest at B 1
#: (tools/profile_mx_decode.py; PERF.md)
DECODE_CHUNK = 64


def decode_plan(t: int) -> tuple:
    """``(splits, chunk)`` of the CUDA decode kernel: each (b, kv-head)
    cell's T keys go to ``splits`` CTAs of DECODE_CHUNK keys (the last
    split may be short). A function of T alone, so the paged wrapper and
    a contiguous call at the same T run the same splits and combine in
    the same order."""
    return -(-t // DECODE_CHUNK), DECODE_CHUNK


def _launch_decode(q, k_elems, k_scales, v_elems, v_scales, kpos, pos, *,
                   fmt_name, block_size, softcap):
    b, kvh, g, d = q.shape
    t, ed = k_elems.shape[2:]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA decode kernel takes bf16 or f32 q, got "
                        f"{q.dtype}")
    for name, x in (("q", q), ("k_elems", k_elems), ("k_scales", k_scales),
                    ("v_elems", v_elems), ("v_scales", v_scales)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    splits, chunk = decode_plan(t)
    lib = _library("mx_attention_decode")
    smem = lib.mx_attention_decode_smem_bytes(g, d, chunk)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"{g} query rows and {chunk}-key tiles of width {d} need {smem} "
            f"bytes of shared memory per CTA; an H100 block has {_MAX_SMEM}")
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    ws_o = torch.empty((b * kvh, splits, g, d), dtype=torch.float32,
                       device=q.device)
    ws_ml = torch.empty((b * kvh, splits, g, 2), dtype=torch.float32,
                        device=q.device)
    err = lib.mx_attention_decode_launch(
        q.data_ptr(), int(q.dtype == torch.float32), k_elems.data_ptr(),
        k_scales.data_ptr(), v_elems.data_ptr(), v_scales.data_ptr(),
        kpos.data_ptr(), pos.data_ptr(), out.data_ptr(), ws_o.data_ptr(),
        ws_ml.data_ptr(), b, kvh, g, d, t, ed, block_size,
        F.FORMAT_IDS[fmt_name], splits, chunk, float(softcap or 0.0),
        float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_attention_decode_launch failed: cudaError "
                           f"{err}")
    mx_attention_decode.launches += 1
    return out


def gather_kv_pages(ke_pool, ks_pool, ve_pool, vs_pool, page_table):
    """Gather per-sequence K/V pages into contiguous compact caches.

    Pools: (NP, PS, KVH, ED) elements (fp8, or packed fp4/fp6 uint8) and
    (NP, PS, KVH, NB) uint8 E8M0 scales; ``page_table`` (B, P) integers,
    entries clipped into ``[0, NP)`` as in the reference (a -1 entry
    reads page 0; callers mask those rows). Returns ``(k_elems, k_scales,
    v_elems, v_scales)`` shaped (B, KVH, P * PS, .), in the pools'
    dtypes. CUDA tensors launch the CUDA kernel (counted in
    ``gather_kv_pages.launches``); CPU tensors run
    :func:`gather_kv_pages_plain`.
    """
    npages, ps, kvh, ed = ke_pool.shape
    if ve_pool.shape != ke_pool.shape or ve_pool.dtype != ke_pool.dtype:
        raise ValueError("k and v element pools must match")
    for name, pool in (("ks_pool", ks_pool), ("vs_pool", vs_pool)):
        if pool.dtype != torch.uint8 or pool.shape[:3] != (npages, ps, kvh) \
                or pool.shape != ks_pool.shape:
            raise ValueError(f"{name} must be ({npages}, {ps}, {kvh}, NB) "
                             "uint8 E8M0 bytes")
    if page_table.ndim != 2 or page_table.is_floating_point():
        raise ValueError("page_table must be (B, P) integers")
    dev = ke_pool.device
    _on_one_device(dev, ks_pool, ve_pool, vs_pool, page_table)
    table = page_table.to(torch.int32).contiguous()
    run = _launch_gather if dev.type == "cuda" else gather_kv_pages_plain
    return run(ke_pool, ks_pool, ve_pool, vs_pool, table)


def mx_attention_decode(q, k_elems, k_scales, v_elems, v_scales, kpos, pos,
                        *, fmt_name: str = "fp8_e4m3", block_size: int = 32,
                        softcap=None):
    """Decode attention against a contiguous MX-quantized cache.

    ``q`` (B, KVH, G, D) bf16 or f32; ``k_elems``/``v_elems`` (B, KVH, T,
    ED) stored elements (fp8, or packed fp4/fp6 uint8) and
    ``k_scales``/``v_scales`` (B, KVH, T, D // block_size) E8M0 bytes;
    ``kpos`` (T,) shared or (B, T) per sequence (-1: an empty slot);
    ``pos`` a scalar or (B,), the last position each query sees. Key t
    counts when ``kpos[t] <= pos`` and ``kpos[t] >= 0``; a row with no
    such key gets the mean of V over T, as in the reference. Returns
    (B, KVH, G, D) f32. CUDA tensors launch the CUDA kernels, a split
    over keys and its combine (:func:`decode_plan`; counted once in
    ``mx_attention_decode.launches``); CPU tensors run
    :func:`mx_attention_decode_plain`.
    """
    _check_fmt(k_elems, fmt_name)
    fmt = F.get_format(fmt_name)
    b, kvh, g, d = q.shape
    t = k_elems.shape[2]
    if d % block_size:
        raise ValueError(f"block_size {block_size} must divide {d}")
    ed, nb = fmt.storage_len(d), d // block_size
    if k_elems.shape != (b, kvh, t, ed) or v_elems.shape != k_elems.shape \
            or v_elems.dtype != k_elems.dtype:
        raise ValueError(f"k_elems/v_elems must be ({b}, {kvh}, T, {ed})")
    for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
        if x.shape != (b, kvh, t, nb) or x.dtype != torch.uint8:
            raise ValueError(f"{name} must be ({b}, {kvh}, {t}, {nb}) uint8")
    dev = q.device
    kpos = torch.as_tensor(kpos, device=dev)
    pos = torch.as_tensor(pos, device=dev)
    if kpos.is_floating_point() or pos.is_floating_point():
        raise ValueError("kpos and pos are integers")
    kpos = kpos.to(torch.int32)
    if kpos.ndim == 1:
        kpos = kpos[None].expand(b, t)
    pos = pos.to(torch.int32)
    if pos.ndim == 0:
        pos = pos[None].expand(b)
    if kpos.shape != (b, t) or pos.shape != (b,):
        raise ValueError(f"kpos must be ({t},) or ({b}, {t}), pos a scalar "
                         f"or ({b},)")
    _on_one_device(dev, k_elems, k_scales, v_elems, v_scales)
    run = _launch_decode if dev.type == "cuda" else mx_attention_decode_plain
    return run(q, k_elems, k_scales, v_elems, v_scales, kpos.contiguous(),
               pos.contiguous(), fmt_name=fmt.name, block_size=block_size,
               softcap=softcap)


def mx_attention_decode_paged(q, ke_pool, ks_pool, ve_pool, vs_pool,
                              page_table, seq_lens, *,
                              fmt_name: str = "fp8_e4m3",
                              block_size: int = 32, softcap=None):
    """Two-pass decode attention through a page table over an MX page
    pool: :func:`gather_kv_pages`, then :func:`mx_attention_decode` over
    the gathered cache with ``kpos = arange(P * PS)`` and ``pos =
    seq_lens - 1`` (the query sits at ``seq_len - 1``). Returns (B, KVH,
    G, D) f32, bit-identical to :func:`mx_attention_decode` on the
    equivalent contiguous cache (the same kernel on the same bytes). The
    reference keeps it as the exactness oracle of the single-pass walk
    :func:`mx_attention_decode_fused`; no engine path runs it."""
    ke, ks, ve, vs = gather_kv_pages(ke_pool, ks_pool, ve_pool, vs_pool,
                                     page_table)
    b, t = q.shape[0], ke.shape[2]
    seq_lens = torch.as_tensor(seq_lens, device=q.device).to(torch.int32)
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)[None] \
        .expand(b, t)
    return mx_attention_decode(q, ke, ks, ve, vs, kpos, seq_lens - 1,
                               fmt_name=fmt_name, block_size=block_size,
                               softcap=softcap)


#: CUDA launches of each kernel (the plain CPU versions are not counted)
mx_attention_ragged_fused.launches = 0
mx_attention_verify_fused.launches = 0
mx_attention_prefill_fused.launches = 0
gather_kv_pages.launches = 0
mx_attention_decode.launches = 0
