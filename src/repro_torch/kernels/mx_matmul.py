"""MX matrix products, the VMXDOTP analogue (port of
``repro.kernels.mx_matmul``).

Three entry points with the reference's layouts (the blocked axis last,
B stored (N, K): the paper's column-major B)::

  mx_matmul_wo     a (M, K) bf16/f32 wide  x  b (N, K) MX   -> (M, N)
  mx_matmul_vv     a (M, K) MX             x  b (N, K) MX   -> (M, N)
  mx_matmul_dgrad  dy (M, N) f32           x  b (N, K) MX   -> dx (M, K)

MX operands are fp8 e4m3 / e5m2 elements ``(rows, K)`` or packed fp4
e2m1 bytes ``(rows, K/2)``, each with E8M0 scales ``(rows, K/k)``. FP6
operands raise ``ValueError``, as the reference's kernels take none.

Each block's power-of-two scale is folded into its decoded elements
(exact) and the contraction runs in ``bk``-wide tiles in ascending order;
each tile's f32 partial is added to the output, in f32 or, with bf16
accumulation, rounded to bf16 and added to the bf16 output, as the
reference's ``o_ref[...] += partial.astype(o_ref.dtype)`` does. On CUDA
tensors each wrapper launches its kernel in ``csrc/mx_matmul.cu``; on CPU
tensors it runs its ``*_plain`` PyTorch version, which repeats that
arithmetic tile by tile.

On the card ``mx_matmul_wo`` and ``mx_matmul_vv`` run one tensor-core
kernel: the MX bytes are decoded to bf16 (exact) in shared memory and
multiplied by ``wgmma``; an f32 ``a`` is split exactly into three bf16
terms (:func:`bf16x3_split`). :func:`matmul_plan` picks its tiles, its
copy path and how far the contraction is split over CTAs (a pure
function of the shapes); a split call also launches a small kernel that
sums the partials, and counts once. ``mx_matmul_dgrad`` runs a sibling
kernel over the same machinery: f32 dy as three bf16 terms, W's tile
decoded as stored (rows along the contraction) and read by ``wgmma`` as a
transposed operand, planned by :func:`dgrad_plan`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core import formats as F

from . import build

#: element formats the matmul kernels take
MATMUL_FORMATS = ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mx_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mx_matmul_tc_launch.argtypes = \
            [p, p, i, p, p, p, p] + [i] * 15 + [p]
        lib.mx_matmul_dgrad_launch.argtypes = [p] * 5 + [i] * 12 + [p]
        for fn in (lib.mx_matmul_tc_launch, lib.mx_matmul_dgrad_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# checks shared by the three wrappers
# ---------------------------------------------------------------------------


def _operand(elems: torch.Tensor, scales: torch.Tensor, fmt_name: str,
             block_size: int, name: str) -> tuple:
    """Check one MX operand; returns (format, rows, logical K)."""
    if fmt_name not in MATMUL_FORMATS:
        raise ValueError(
            f"the MX matmul kernels take {MATMUL_FORMATS} operands, not "
            f"{fmt_name}")
    fmt = F.get_format(fmt_name)
    if elems.ndim != 2 or scales.ndim != 2 \
            or elems.shape[0] != scales.shape[0]:
        raise ValueError(f"{name}: elements (rows, storage) and scales "
                         f"(rows, K/k) expected, got {tuple(elems.shape)} "
                         f"and {tuple(scales.shape)}")
    if elems.dtype != fmt.storage_dtype or scales.dtype != torch.uint8:
        raise ValueError(f"{name}: {fmt_name} elements are "
                         f"{fmt.storage_dtype} and scales uint8, got "
                         f"{elems.dtype} and {scales.dtype}")
    k = scales.shape[1] * block_size
    if fmt.storage_len(k) != elems.shape[1]:
        raise ValueError(f"{name}: {scales.shape[1]} blocks of {block_size} "
                         f"need {fmt.storage_len(k)} storage entries per "
                         f"row, got {elems.shape[1]}")
    return fmt, elems.shape[0], k


def _check_tile(tile: int, k: int, fmt: F.ElementFormat, block_size: int):
    if tile < 1 or k % tile or tile % block_size:
        raise ValueError(f"tile {tile} must divide {k} and be a multiple of "
                         f"the block size {block_size}")
    if fmt.packed and tile % 2:
        raise ValueError(f"fp4 tiles must be even, got {tile}")


def _device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no MX matmul kernel for device {dev}")
    return dev


def _check_acc(acc_dtype) -> None:
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"acc_dtype must be f32 or bf16, got {acc_dtype}")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary: the tensor-core kernel
    copies 16-byte chunks counted from the base (a view at an odd offset
    is copied once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_tc(name: str, a, a_scales, a_kind: str, b_elems, b_scales,
               k: int, fmt_name: str, block_size: int, acc_dtype, bk: int):
    """One call of the tensor-core kernel (and of the reduce kernel when
    the plan splits the contraction) on CUDA tensors; returns (M, N)."""
    m, n = a.shape[0], b_elems.shape[0]
    plan = matmul_plan(m, n, k, bk, fmt_name, block_size, a_kind, acc_dtype)
    a = _aligned(a if a_kind != "mx" else a.view(torch.uint8))
    a_s = _aligned(a_scales) if a_kind == "mx" else None
    be, bs = _aligned(_bytes(b_elems)), _aligned(b_scales)
    out = torch.empty((m, n), dtype=acc_dtype, device=a.device)
    ws = (torch.empty(plan.workspace_shape(m, n), dtype=torch.float32,
                      device=a.device) if plan.ws_slots else None)
    err = _library().mx_matmul_tc_launch(
        a.data_ptr(), a_s.data_ptr() if a_s is not None else None,
        A_KINDS[a_kind], be.data_ptr(), bs.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k,
        a.shape[1] * a.element_size(), be.shape[1], block_size,
        F.FORMAT_IDS[fmt_name], bk, plan.w, plan.bm, plan.splits,
        plan.tiles_per_split, plan.ws_slots, int(acc_dtype == torch.bfloat16),
        int(plan.lean), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: mx_matmul_tc_launch failed: cudaError "
                           f"{err}")
    return out


# ---------------------------------------------------------------------------
# the tensor-core kernel's plan and its f32 split
# ---------------------------------------------------------------------------

#: streaming multiprocessors of an H100 SXM: the plan splits the
#: contraction until the CTAs fill them
SMS = 132
#: weight rows of one CTA (two halves of 64 rows: wgmma's M)
TILE_N = 128
#: contraction elements of one pipeline stage, at most
STAGE_K = 64
#: A-operand kinds of the kernel (``a_kind`` of mx_matmul_tc_launch)
A_KINDS = {"mx": 0, "bf16": 1, "f32": 2}


@dataclass(frozen=True)
class MatmulPlan:
    """How ``mx_matmul_tc_kernel`` covers out (M, N) = A (M, K) . B^T.

    CTAs form an (m_tiles, n_tiles, splits) grid: ``bm`` activation rows
    (wgmma's N) by ``TILE_N`` weight rows, over ``tiles_per_split``
    consecutive ``bk`` tiles of the contraction, each run in ``w``-wide
    stages. ``lean`` stages (64 elements, blocks of a multiple of 8, K /
    block a multiple of 16, every stored row a multiple of 16 bytes) arrive
    by TMA; others by cp.async copies of the 16-byte chunks that cover each
    row. With ``splits`` > 1
    each CTA writes f32 partials to a workspace of ``ws_slots`` (M, N)
    slices: one per split with f32 accumulation, one per bk tile with bf16
    accumulation (each tile rounds on its own); a second kernel sums them
    in ascending order.
    """

    bm: int
    w: int
    lean: bool
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int
    tiles_per_split: int
    ws_slots: int

    def ranges(self) -> list:
        """``[t0, t1)`` bk tiles of each split, in split order."""
        t = self.tiles_per_split
        return [(s * t, min((s + 1) * t, self.k_tiles))
                for s in range(self.splits)]

    def workspace_shape(self, m: int, n: int) -> tuple:
        return (self.ws_slots, m, n)


def _stage_width(bk: int, block_size: int, packed: bool) -> int:
    """Largest divisor of ``bk`` that is at most STAGE_K and 16 blocks (a
    stage's E8M0 bytes fit their ring slot), even for packed fp4."""
    cap = min(STAGE_K, 16 * block_size, bk)
    for w in range(cap, 0, -1):
        if bk % w == 0 and not (packed and w % 2):
            return w
    raise ValueError(f"no stage width for bk {bk}")


def matmul_plan(m: int, n: int, k: int, bk: int, fmt_name: str,
                block_size: int = 32, a_kind: str = "mx",
                acc_dtype=torch.float32) -> MatmulPlan:
    """The tensor-core kernel's tiles and contraction split for one call.

    ``bm`` is the smallest of 16, 64 and 128 that holds ``m``; 128 only on
    the lean path with f32 accumulation and a bf16 or MX A (an f32 A's
    three bf16 terms take three tiles of shared memory; bf16
    accumulation's running sum takes registers). Where the
    (m, n) tiles alone leave SMs idle (a decode step's M = 8 streams 61 MB
    of weights at gate/up), the contraction is split by bk tiles until the
    CTAs fill the card: two resident CTAs an SM at ``bm`` 16, one
    otherwise.
    """
    if a_kind not in A_KINDS:
        raise ValueError(f"a_kind must be one of {tuple(A_KINDS)}")
    if k % bk:
        raise ValueError(f"bk {bk} must divide K = {k}")
    fmt = F.get_format(fmt_name)
    w = _stage_width(bk, block_size, fmt.packed)
    a_row = {"mx": fmt.storage_len(k), "bf16": 2 * k, "f32": 4 * k}[a_kind]
    lean = (w == STAGE_K and block_size % 8 == 0
            and (k // block_size) % 16 == 0
            and fmt.storage_len(k) % 16 == 0 and a_row % 16 == 0)
    wide = lean and a_kind != "f32" and acc_dtype == torch.float32
    bm = next(b for b in (16, 64, 128) if m <= b or b == (128 if wide else 64))
    m_tiles, n_tiles, k_tiles = -(-m // bm), -(-n // TILE_N), k // bk
    tiles_per_split, splits = _split(m_tiles * n_tiles, k_tiles, bm)
    if splits == 1:
        slots = 0
    else:
        slots = k_tiles if acc_dtype == torch.bfloat16 else splits
    return MatmulPlan(bm, w, lean, m_tiles, n_tiles, k_tiles, splits,
                      tiles_per_split, slots)


def _split(ctas: int, k_tiles: int, bm: int) -> tuple:
    """(tiles_per_split, splits): the contraction's tiles split over CTAs
    until ``ctas`` output tiles fill the card (two resident CTAs an SM at
    ``bm`` 16, one otherwise)."""
    target = SMS * (2 if bm == 16 else 1)
    want = max(1, min(k_tiles, target // ctas))
    tiles_per_split = -(-k_tiles // want)
    return tiles_per_split, -(-k_tiles // tiles_per_split)


def dgrad_plan(m: int, n: int, k: int, bn: int, fmt_name: str,
               block_size: int = 32) -> MatmulPlan:
    """The dgrad kernel's tiles for dx (M, K) = dy (M, N) . W, W (N, K).

    CTAs form an (m_tiles, n_tiles, splits) grid: ``bm`` (16 or 64) dx
    rows by ``TILE_N`` dx columns, over ``tiles_per_split`` consecutive
    ``bn`` tiles of the contraction N, each run in ``w``-wide stages (the
    largest divisor of bn up to STAGE_K; the contraction carries no block
    structure). Every stage arrives by cp.async; ``lean`` here means the
    vector decode (blocks a multiple of 8, W's stored rows a multiple of
    16 bytes). With ``splits`` > 1 each split writes its f32 partial to
    one of ``ws_slots`` (M, K) slices, summed in ascending order by the
    reduce kernel. A pure function of the shapes.
    """
    if bn < 1 or n % bn:
        raise ValueError(f"bn {bn} must divide N = {n}")
    fmt = F.get_format(fmt_name)
    w = next(s for s in range(min(STAGE_K, bn), 0, -1) if bn % s == 0)
    lean = block_size % 8 == 0 and fmt.storage_len(k) % 16 == 0
    bm = 16 if m <= 16 else 64
    m_tiles, n_tiles, k_tiles = -(-m // bm), -(-k // TILE_N), n // bn
    tiles_per_split, splits = _split(m_tiles * n_tiles, k_tiles, bm)
    return MatmulPlan(bm, w, lean, m_tiles, n_tiles, k_tiles, splits,
                      tiles_per_split, splits if splits > 1 else 0)


def bf16x3_split(a: torch.Tensor) -> tuple:
    """Plain version of the kernel's split of a flushed f32 ``a`` into
    three bf16 terms with ``hi + mid + lo == a``: ``hi`` and ``mid`` by
    truncation to bf16 (exact; never overflows), ``lo`` the remainder,
    which has at most 8 significant bits and is a bf16 value (subnormal
    included) for ``|a| >= 2**-110``. The low terms are not flushed."""
    def trunc(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)

    a = a.float()
    hi = trunc(a)
    r = a - hi
    mid = trunc(r)
    lo = r - mid
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _dequant(elems: torch.Tensor, scales: torch.Tensor, fmt: F.ElementFormat,
             block_size: int, k0: int, k1: int) -> torch.Tensor:
    """Elements [k0, k1) of every row, decoded to f32 with the block scales
    folded in (``_decode_tile`` + ``_fold_scales``), subnormals flushed."""
    return F.dequantize_blocks(
        elems[:, fmt.storage_len(k0):fmt.storage_len(k1)],
        scales[:, k0 // block_size:k1 // block_size], fmt, block_size)


def _accumulate(out: torch.Tensor, partial: torch.Tensor) -> torch.Tensor:
    """``o += partial.astype(o.dtype)``: a bf16 output rounds the partial,
    then the sum."""
    if out.dtype == torch.float32:
        return out + partial
    return (out.float() + partial.to(out.dtype).float()).to(out.dtype)


def mx_matmul_wo_plain(a, b_elems, b_scales, *, fmt_name="fp8_e4m3",
                       block_size=32, acc_dtype=torch.float32, bk=512):
    """PyTorch version of the weight-only kernel (same arguments)."""
    fmt = F.get_format(fmt_name)
    m, k = a.shape
    af = F.flush_subnormals(a.float())
    out = torch.zeros((m, b_elems.shape[0]), dtype=acc_dtype, device=a.device)
    for k0 in range(0, k, bk):
        b = _dequant(b_elems, b_scales, fmt, block_size, k0, k0 + bk)
        out = _accumulate(out, af[:, k0:k0 + bk] @ b.T)
    return out


def mx_matmul_vv_plain(a_elems, a_scales, b_elems, b_scales, *,
                       fmt_name="fp8_e4m3", block_size=32,
                       acc_dtype=torch.float32, bk=512):
    """PyTorch version of the MX x MX kernel (same arguments)."""
    fmt = F.get_format(fmt_name)
    k = a_scales.shape[1] * block_size
    out = torch.zeros((a_elems.shape[0], b_elems.shape[0]), dtype=acc_dtype,
                      device=a_elems.device)
    for k0 in range(0, k, bk):
        a = _dequant(a_elems, a_scales, fmt, block_size, k0, k0 + bk)
        b = _dequant(b_elems, b_scales, fmt, block_size, k0, k0 + bk)
        out = _accumulate(out, a @ b.T)
    return out


def mx_matmul_dgrad_plain(dy, b_elems, b_scales, *, fmt_name="fp8_e4m3",
                          block_size=32, bn=128):
    """PyTorch version of the dgrad kernel (same arguments)."""
    fmt = F.get_format(fmt_name)
    m, n = dy.shape
    k = b_scales.shape[1] * block_size
    dyf = F.flush_subnormals(dy.float())
    out = torch.zeros((m, k), dtype=torch.float32, device=dy.device)
    for n0 in range(0, n, bn):
        w = _dequant(b_elems[n0:n0 + bn], b_scales[n0:n0 + bn], fmt,
                     block_size, 0, k)
        out = out + dyf[:, n0:n0 + bn] @ w
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def mx_matmul_wo(a, b_elems, b_scales, *, fmt_name="fp8_e4m3", block_size=32,
                 acc_dtype=torch.float32, bk=512):
    """Wide ``a (M, K)`` x MX ``b (N, K)`` -> ``(M, N)`` in ``acc_dtype``.

    ``bk`` is the contraction tile of each partial sum: it sets where a
    bf16 accumulation rounds. CUDA tensors launch the kernel (counted in
    ``mx_matmul_wo.launches``); CPU tensors run the plain version.
    """
    fmt, n, k = _operand(b_elems, b_scales, fmt_name, block_size, "b")
    if a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"a must be (M, {k}), got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be f32 or bf16, got {a.dtype}")
    _check_tile(bk, k, fmt, block_size)
    _check_acc(acc_dtype)
    kw = dict(fmt_name=fmt_name, block_size=block_size, acc_dtype=acc_dtype,
              bk=bk)
    if _device(a, b_elems, b_scales).type == "cpu":
        return mx_matmul_wo_plain(a, b_elems, b_scales, **kw)
    kind = "bf16" if a.dtype == torch.bfloat16 else "f32"
    out = _launch_tc("mx_matmul_wo", a, None, kind, b_elems, b_scales, k,
                     fmt_name, block_size, acc_dtype, bk)
    mx_matmul_wo.launches += 1
    return out


def mx_matmul_vv(a_elems, a_scales, b_elems, b_scales, *, fmt_name="fp8_e4m3",
                 block_size=32, acc_dtype=torch.float32, bk=512):
    """MX ``a (M, K)`` x MX ``b (N, K)`` -> ``(M, N)`` (paper Eq. 2).

    Both operands share ``fmt_name`` and ``block_size``. CUDA tensors
    launch the kernel (counted in ``mx_matmul_vv.launches``); CPU tensors
    run the plain version.
    """
    fmt, m, k = _operand(a_elems, a_scales, fmt_name, block_size, "a")
    _, n, kb = _operand(b_elems, b_scales, fmt_name, block_size, "b")
    if kb != k:
        raise ValueError(f"a has K = {k}, b has K = {kb}")
    _check_tile(bk, k, fmt, block_size)
    _check_acc(acc_dtype)
    kw = dict(fmt_name=fmt_name, block_size=block_size, acc_dtype=acc_dtype,
              bk=bk)
    if _device(a_elems, a_scales, b_elems, b_scales).type == "cpu":
        return mx_matmul_vv_plain(a_elems, a_scales, b_elems, b_scales, **kw)
    out = _launch_tc("mx_matmul_vv", a_elems, a_scales, "mx", b_elems,
                     b_scales, k, fmt_name, block_size, acc_dtype, bk)
    mx_matmul_vv.launches += 1
    return out


def mx_matmul_dgrad(dy, b_elems, b_scales, *, fmt_name="fp8_e4m3",
                    block_size=32, bn=128):
    """``dx (M, K) = dy (M, N) @ dequant(W)`` for W stored (N, K) blocked
    along K: the forward weight layout is read as it is, nothing is
    transposed. f32 output; ``bn`` is the contraction tile over N.
    CUDA tensors launch the kernel (counted in
    ``mx_matmul_dgrad.launches``); CPU tensors run the plain version.
    """
    fmt, n, k = _operand(b_elems, b_scales, fmt_name, block_size, "b")
    if dy.ndim != 2 or dy.shape[1] != n:
        raise ValueError(f"dy must be (M, {n}), got {tuple(dy.shape)}")
    if dy.dtype != torch.float32:
        raise TypeError(f"dy must be f32, got {dy.dtype}")
    if bn < 1 or n % bn:
        raise ValueError(f"bn {bn} must divide N = {n}")
    kw = dict(fmt_name=fmt_name, block_size=block_size, bn=bn)
    if _device(dy, b_elems, b_scales).type == "cpu":
        return mx_matmul_dgrad_plain(dy, b_elems, b_scales, **kw)
    m = dy.shape[0]
    plan = dgrad_plan(m, n, k, bn, fmt_name, block_size)
    dy, be, bs = _aligned(dy), _aligned(_bytes(b_elems)), _aligned(b_scales)
    dx = torch.empty((m, k), dtype=torch.float32, device=dy.device)
    ws = (torch.empty(plan.workspace_shape(m, k), dtype=torch.float32,
                      device=dy.device) if plan.ws_slots else None)
    err = _library().mx_matmul_dgrad_launch(
        dy.data_ptr(), be.data_ptr(), bs.data_ptr(), dx.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, be.shape[1], bn,
        plan.w, plan.bm, plan.splits, plan.tiles_per_split, block_size,
        F.FORMAT_IDS[fmt_name], int(plan.lean),
        torch.cuda.current_stream(dy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_matmul_dgrad_launch failed: cudaError {err}")
    mx_matmul_dgrad.launches += 1
    return dx


#: CUDA launches of each kernel (the plain CPU versions are not counted)
mx_matmul_wo.launches = 0
mx_matmul_vv.launches = 0
mx_matmul_dgrad.launches = 0
