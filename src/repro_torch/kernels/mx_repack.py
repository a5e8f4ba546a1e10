"""Repack tiered KV pool pages down (or up) the MX format ladder, in place.

Port of ``repro.kernels.mx_repack.mx_repack_pages``, the tiering engine's
workhorse. Tiered pools hold full-width uint8 rows (NP, PS, KVH, D) and
E8M0 scales (NP, PS, KVH, D // k); a page's codes fill the row prefix in
the format its per-page id names. Per listed page the repack decodes the
rows under the page's source format, re-encodes them to the destination
with recomputed scales (emax differs per format, so the old shared
exponents are wrong for the new grid), writes the codes into the row
prefix and zeroes the dead tail bytes.

The pools may also come layer-stacked, (L, NP, PS, KVH, D) rows and
(L, NP, PS, KVH, D // k) scales, as a uniform model's ``PagedCache.stack``
holds them: the page list then applies to every layer, and one launch
repacks them all.

:func:`mx_repack_pages` launches the hand-written kernel in
``csrc/mx_repack.cu`` on CUDA tensors and runs
:func:`mx_repack_pages_plain` on CPU tensors. The pools update in place
(the reference aliases them through the ``pallas_call``).

The page list is a fixed-length (N,) operand whose live prefix is
``count`` entries long; entries past it do nothing. The caller flips the
pages' format ids after the call, and lists each page at most once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F

from . import build
from .mx_attention import MIXED_FMTS_DEFAULT, _dequant_rows_mixed
from .mx_quantize import quantize_rows

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mx_repack")
        fn = lib.mx_repack_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def mx_repack_pages_plain(ke, ks, ve, vs, page_ids, src_fmts, count: int, *,
                          dst_fmt_name: str, mixed_fmts, block_size: int):
    """PyTorch version of the kernel: entries ``n < count`` in order,
    decoded as the ragged kernel decodes a mixed page (the arithmetic
    byte decode, scales folded, subnormals flushed) and re-encoded by
    :func:`~.mx_quantize.quantize_rows`; layer-stacked pools layer by
    layer. Returns the four pools."""
    if ke.ndim == 5:
        for layer in zip(ke, ks, ve, vs):
            mx_repack_pages_plain(*layer, page_ids, src_fmts, count,
                                  dst_fmt_name=dst_fmt_name,
                                  mixed_fmts=mixed_fmts,
                                  block_size=block_size)
        return ke, ks, ve, vs
    dst = F.get_format(dst_fmt_name)
    w = dst.storage_len(ke.shape[-1])
    ids = page_ids.tolist()
    fmts = src_fmts.tolist()
    for n in range(count):
        pid = ids[n]
        for elems, scales in ((ke, ks), (ve, vs)):
            wide = _dequant_rows_mixed(elems[pid], scales[pid], fmts[n],
                                       mixed_fmts, block_size)
            codes, e = quantize_rows(wide, dst, block_size)
            elems[pid, ..., :w] = codes
            elems[pid, ..., w:] = 0
            scales[pid] = e
    return ke, ks, ve, vs


def _launch(ke, ks, ve, vs, ids, fmts, count, dst, mixed_fmts, block_size):
    for name, t in (("ke", ke), ("ks", ks), ("ve", ve), ("vs", vs),
                    ("page_ids", ids), ("src_fmts", fmts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_size % 4:
        raise ValueError("the CUDA repack kernel packs whole bytes per "
                         f"block: block_size must be a multiple of 4, not "
                         f"{block_size}")
    layers, npages, ps, kvh, d = ke.shape if ke.ndim == 5 else (1,
                                                                 *ke.shape)
    mask = 0
    for name in mixed_fmts:
        mask |= 1 << F.FORMAT_IDS[name]
    stream = torch.cuda.current_stream(ke.device).cuda_stream
    err = _library().mx_repack_launch(
        ke.data_ptr(), ks.data_ptr(), ve.data_ptr(), vs.data_ptr(),
        ids.data_ptr(), fmts.data_ptr(), ids.shape[0], count, layers,
        npages, kvh, ps, d, block_size, F.FORMAT_IDS[dst.name], mask,
        F.FORMAT_IDS[mixed_fmts[0]], stream)
    if err != 0:
        raise RuntimeError(f"mx_repack_launch failed: cudaError {err}")
    mx_repack_pages.launches += 1
    return ke, ks, ve, vs


def mx_repack_pages(ke, ks, ve, vs, page_ids, src_fmts, count, *,
                    dst_fmt_name: str, mixed_fmts=None, block_size: int = 32):
    """Repack the first ``count`` pages of ``page_ids`` to ``dst_fmt_name``
    in place; ``src_fmts`` holds their current format ids
    (``core.formats.FORMAT_IDS``; an id outside ``mixed_fmts`` decodes as
    its first format). ``page_ids`` and ``src_fmts`` are (N,) integer
    tensors on the pools' device, ids are clipped into the pool, and
    ``count`` is an int in [1, N]. The pools are one layer's, or
    layer-stacked with a leading L shared by all four, every layer
    repacking the same pages. Returns the four pools. CUDA tensors
    launch the CUDA kernel once (counted in ``mx_repack_pages.launches``);
    CPU tensors run :func:`mx_repack_pages_plain`.
    """
    if ke.dtype != torch.uint8:
        raise ValueError(
            "mx_repack_pages operates on mixed-format (tiered) pools, "
            f"which store raw uint8 bytes; got {ke.dtype}")
    mixed_fmts = tuple(mixed_fmts or MIXED_FMTS_DEFAULT)
    if dst_fmt_name not in F.FORMAT_IDS:
        raise ValueError(f"unknown target format {dst_fmt_name!r}")
    dst = F.get_format(dst_fmt_name)
    lead = ()
    if ke.ndim == 5:
        lead = ke.shape[:1]
        if any(t.ndim != 5 or t.shape[0] != lead[0] for t in (ks, ve, vs)):
            raise ValueError(
                "layer-stacked pools must share their leading L: got "
                f"{[tuple(t.shape) for t in (ke, ks, ve, vs)]}")
    if ke.ndim - len(lead) != 4:
        raise ValueError(f"tiered pools must be (NP, PS, KVH, D) uint8 and "
                         f"(NP, PS, KVH, D // {block_size}) scales")
    npages, ps, kvh, d = ke.shape[len(lead):]
    nb = d // block_size
    if d % block_size or ve.shape != ke.shape \
            or ks.shape != (*lead, npages, ps, kvh, nb) \
            or vs.shape != ks.shape:
        raise ValueError(f"tiered pools must be (NP, PS, KVH, D) uint8 and "
                         f"(NP, PS, KVH, D // {block_size}) scales"
                         + (", each under a leading L" if lead else ""))
    if any(t.dtype != torch.uint8 for t in (ks, ve, vs)):
        raise ValueError("tiered pools and scales must all be uint8")
    dst.storage_len(d)  # raises unless D packs into whole bytes
    n = page_ids.shape[0]
    count = int(count)
    if page_ids.shape != (n,) or src_fmts.shape != (n,) or \
            not 1 <= count <= n:
        raise ValueError(f"page_ids and src_fmts must be (N,) with "
                         f"1 <= count <= N; got count {count}, N {n}")
    dev = ke.device
    if any(t.device != dev for t in (ks, ve, vs, page_ids, src_fmts)):
        raise ValueError("all inputs must be on one device")
    ids = page_ids.to(torch.int32).contiguous()
    fmts = src_fmts.to(torch.int32).contiguous()
    if dev.type == "cuda":  # the kernel clips the ids itself
        return _launch(ke, ks, ve, vs, ids, fmts, count, dst, mixed_fmts,
                       block_size)
    if dev.type == "cpu":
        return mx_repack_pages_plain(
            ke, ks, ve, vs, ids.clamp(0, npages - 1), fmts, count,
            dst_fmt_name=dst.name, mixed_fmts=mixed_fmts,
            block_size=block_size)
    raise NotImplementedError(f"no repack kernel for device {dev}")


#: CUDA launches of the kernel (the plain CPU version is not counted)
mx_repack_pages.launches = 0
