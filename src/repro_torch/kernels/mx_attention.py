"""Ragged MX page-walk attention with the in-kernel K/V page write.

Port of ``repro.kernels.mx_attention.mx_attention_ragged_fused``, the one
kernel of the reference's default engine step.
:func:`mx_attention_ragged_fused` takes the reference's layouts and
returns its outputs; on CUDA tensors it launches the hand-written kernel
in ``csrc/mx_attention_ragged.cu`` and on CPU tensors it runs
:func:`mx_attention_ragged_fused_plain`, a page-by-page PyTorch version
of the same algorithm. The pools are updated
in place (the reference aliases them through the ``pallas_call``).

Layouts::

  q          (R, KVH, W, G, D)  bf16 step queries (RoPE'd)
  k_new      (R, W, KVH, D)     bf16 new keys (RoPE'd)
  v_new      (R, W, KVH, D)     bf16 new values
  ke / ve    (NP, PS, KVH, ED)  element pools: fp8 (ED = D), packed fp4
                                uint8 (ED = D/2), or mixed-format uint8
                                rows (ED = D, a page's codes in the row
                                prefix, its format in ``page_fmts``)
  ks / vs    (NP, PS, KVH, D//k) uint8 E8M0 scale pools
  page_table (R, P) int         entries < 0 map to the trash page NP - 1
  row_start  (R,) int           first position this step writes
  seq_lens   (R,) int           row_start + n_new, n_new in [1, W]
  page_fmts  (NP,) int32        mixed pools: each page's format id
  out        (R, KVH, W, G, D)  f32
  visits     (R, KVH, 1) int32  pages each cell walked
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F

from . import build
from .mx_quantize import quantize_rows

NEG_INF = -2.0e38

#: shared memory an H100 block may use (bytes)
_MAX_SMEM = 232448

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mx_attention_ragged")
        fn = lib.mx_attention_ragged_launch
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mx_attention_ragged_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.mx_attention_ragged_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


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
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    probs = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
    l = l * alpha + probs.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(probs, v)
    return m_new, l, acc


# ---------------------------------------------------------------------------
# plain version and CUDA launch
# ---------------------------------------------------------------------------


def mx_attention_ragged_fused_plain(q, k_new, v_new, ke, ks, ve, vs, table,
                                    row_start, seq_lens, *,
                                    fmt_name: str, block_size: int,
                                    softcap=None, window=None,
                                    page_fmts=None, mixed_fmts=None):
    """Page-by-page PyTorch version of the kernel, same layouts.

    Expects the rows normalised by :func:`normalize_rows`. Rows run in
    order and, within a row, each page of the write window is merged
    before it is attended, as the reference's sequential grid does. The
    pools are updated in place. With ``page_fmts`` the pools are mixed:
    new rows land as ``fmt_name`` (an fp8) bytes, and every page decodes
    under its own format id. Returns ``(out, visits)``.
    """
    fmt = F.get_format(fmt_name)
    r, kvh, w, g, d = q.shape
    rows = w * g
    ps = ke.shape[1]
    pmax = table.shape[1]
    dev = q.device
    scale = d ** -0.5
    pools = [p.view(torch.uint8) for p in (ke, ks, ve, vs)]
    if page_fmts is None:
        def dequant(page, elems, scales):
            return _dequant_rows(elems[page], scales[page], fmt, block_size)
    else:
        fmt_ids = page_fmts.tolist()

        def dequant(page, elems, scales):
            return _dequant_rows_mixed(elems[page], scales[page],
                                       fmt_ids[page], mixed_fmts, block_size)
    out = torch.empty((r, kvh, rows, d), dtype=torch.float32, device=dev)
    visits = torch.zeros((r, kvh, 1), dtype=torch.int32, device=dev)
    tbl = table.tolist()
    starts = row_start.tolist()
    lens = seq_lens.tolist()
    q_idx = torch.arange(rows, device=dev) // g
    page_rows = torch.arange(ps, device=dev)
    for i in range(r):
        start, seq_len = starts[i], lens[i]
        w0 = start // ps
        valid = min(-(-seq_len // ps), pmax)
        first = _first_window_page(start, window, ps)
        qpos = start + torch.clamp(q_idx, max=seq_len - start - 1)
        qf = q[i].reshape(kvh, rows, d).to(torch.float32)
        state = (torch.full((kvh, rows, 1), NEG_INF, device=dev),
                 torch.zeros((kvh, rows, 1), device=dev),
                 torch.zeros((kvh, rows, d), device=dev))
        for p in range(first, valid):
            page = tbl[i][p]
            kpos = p * ps + page_rows
            if p >= w0:
                # write window: new row t lands on page row j where
                # start + t == p * PS + j; other rows keep their bytes
                # (a page row is one token's whole row, so the merge never
                # splits a packed byte)
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
            kt = dequant(page, pools[0], pools[1]).transpose(0, 1)
            vt = dequant(page, pools[2], pools[3]).transpose(0, 1)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            state = _flash_update(state, qf, kt, vt, mask, softcap, scale)
        _, l, acc = state
        out[i] = acc / l
        visits[i] = max(0, valid - first)
    return out.reshape(r, kvh, w, g, d), visits


def normalize_rows(page_table, row_start, seq_lens, num_pages: int,
                   width: int):
    """The reference wrapper's row metadata normalisation: negative table
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


def _launch(q, k_new, v_new, ke, ks, ve, vs, table, start, lens, *,
            fmt_name, block_size, softcap, window, page_fmts, mixed_fmts):
    r, kvh, w, g, d = q.shape
    if q.dtype != torch.bfloat16 or k_new.dtype != torch.bfloat16 \
            or v_new.dtype != torch.bfloat16:
        raise TypeError("the CUDA ragged kernel takes bf16 q/k_new/v_new")
    tensors = [("q", q), ("k_new", k_new), ("v_new", v_new), ("ke", ke),
               ("ks", ks), ("ve", ve), ("vs", vs)]
    if page_fmts is not None:
        tensors.append(("page_fmts", page_fmts))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ps, ed = ke.shape[1], ke.shape[-1]
    if ps > 32:
        raise NotImplementedError("the CUDA ragged kernel takes page_size "
                                  "<= 32")
    # one lane per key of a page tile; the P.V loop gives each lane
    # D / lanes of the logical head dim, however narrow the stored row
    lanes = 1 << max(ps - 1, 0).bit_length()
    if d % lanes:
        raise NotImplementedError(
            f"head_dim {d} must be a multiple of {lanes} (page_size rounded "
            "up to a power of two)")
    lib = _library()
    smem = lib.mx_attention_ragged_smem_bytes(w, g, d, ps)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"W*G={w * g} query rows x head_dim {d} need {smem} bytes of "
            f"shared memory per CTA; an H100 block has {_MAX_SMEM}")
    mask = default = 0
    if page_fmts is not None:
        for name in mixed_fmts:
            mask |= 1 << F.FORMAT_IDS[name]
        default = F.FORMAT_IDS[mixed_fmts[0]]
    out = torch.empty((r, kvh, w, g, d), dtype=torch.float32,
                      device=q.device)
    visits = torch.empty((r, kvh, 1), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mx_attention_ragged_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ke.data_ptr(),
        ks.data_ptr(), ve.data_ptr(), vs.data_ptr(), table.data_ptr(),
        start.data_ptr(), lens.data_ptr(),
        None if page_fmts is None else page_fmts.data_ptr(),
        out.data_ptr(), visits.data_ptr(), r, kvh, w, g, d, ed, ps,
        table.shape[1], block_size, F.FORMAT_IDS[fmt_name],
        -1 if window is None else int(window), mask, default,
        float(softcap or 0.0), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"mx_attention_ragged_launch failed: cudaError "
                           f"{err}")
    mx_attention_ragged_fused.launches += 1
    return out, visits


def mx_attention_ragged_fused(q, k_new, v_new, ke, ks, ve, vs, page_table,
                              row_start, seq_lens, *,
                              fmt_name: str = "fp8_e4m3",
                              block_size: int = 32, softcap=None,
                              window=None, page_fmts=None, mixed_fmts=None,
                              debug_visits: bool = False):
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
    """
    fmt = F.get_format(fmt_name)
    mixed = page_fmts is not None
    _check_fmt(ke, fmt_name, mixed=mixed)
    _check_fmt(ve, fmt_name, mixed=mixed)
    r, kvh, w, g, d = q.shape
    npages, ps = ke.shape[:2]
    if mixed:
        mixed_fmts = tuple(mixed_fmts or MIXED_FMTS_DEFAULT)
        if fmt.bits != 8:
            raise ValueError(
                "tiered ragged steps write the window in the hot format, "
                f"which must be an fp8; got {fmt_name!r}")
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
    if k_new.shape != (r, w, kvh, d) or v_new.shape != (r, w, kvh, d):
        raise ValueError(f"k_new/v_new must be {(r, w, kvh, d)}")
    if ke.shape != (npages, ps, kvh, ed) or ve.shape != ke.shape:
        raise ValueError(f"element pools must be (NP, PS, {kvh}, {ed})")
    if ks.shape != (npages, ps, kvh, d // block_size) or vs.shape != ks.shape:
        raise ValueError(f"scale pools must be (NP, PS, {kvh}, "
                         f"{d // block_size})")
    if d % block_size:
        raise ValueError(f"block_size {block_size} must divide {d}")
    if page_table.ndim != 2 or page_table.shape[0] != r \
            or row_start.shape != (r,) or seq_lens.shape != (r,):
        raise ValueError(f"page_table must be ({r}, P) and row_start / "
                         f"seq_lens ({r},)")
    if any(t.is_floating_point() for t in (page_table, row_start, seq_lens)):
        raise ValueError("page_table, row_start and seq_lens are integers")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    dev = q.device
    tensors = (k_new, v_new, ke, ks, ve, vs, page_table, row_start,
               seq_lens) + ((page_fmts,) if mixed else ())
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    table, start, lens = normalize_rows(page_table, row_start, seq_lens,
                                        npages, w)
    kw = dict(fmt_name=fmt.name, block_size=block_size, softcap=softcap,
              window=window, page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    if dev.type == "cuda":
        out, visits = _launch(q, k_new, v_new, ke, ks, ve, vs, table, start,
                              lens, **kw)
    elif dev.type == "cpu":
        out, visits = mx_attention_ragged_fused_plain(
            q, k_new, v_new, ke, ks, ve, vs, table, start, lens, **kw)
    else:
        raise NotImplementedError(f"no ragged kernel for device {dev}")
    pools = (ke, ks, ve, vs)
    return (out, pools, visits) if debug_visits else (out, pools)


#: CUDA launches of the kernel (the plain CPU version is not counted)
mx_attention_ragged_fused.launches = 0
