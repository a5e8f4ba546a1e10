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
"""
from __future__ import annotations

import ctypes

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
        lib.mx_matmul_wo_launch.argtypes = [p, i, p, p, p] + [i] * 8 + [p]
        lib.mx_matmul_vv_launch.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.mx_matmul_dgrad_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        for fn in (lib.mx_matmul_wo_launch, lib.mx_matmul_vv_launch,
                   lib.mx_matmul_dgrad_launch):
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


def _acc_flag(acc_dtype) -> int:
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"acc_dtype must be f32 or bf16, got {acc_dtype}")
    return int(acc_dtype == torch.bfloat16)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


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
    out_bf16 = _acc_flag(acc_dtype)
    kw = dict(fmt_name=fmt_name, block_size=block_size, acc_dtype=acc_dtype,
              bk=bk)
    if _device(a, b_elems, b_scales).type == "cpu":
        return mx_matmul_wo_plain(a, b_elems, b_scales, **kw)
    a, be, bs = a.contiguous(), _bytes(b_elems), b_scales.contiguous()
    m = a.shape[0]
    out = torch.empty((m, n), dtype=acc_dtype, device=a.device)
    err = _library().mx_matmul_wo_launch(
        a.data_ptr(), int(a.dtype == torch.bfloat16), be.data_ptr(),
        bs.data_ptr(), out.data_ptr(), m, n, k, b_elems.shape[1], bk,
        block_size, F.FORMAT_IDS[fmt_name], out_bf16,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_matmul_wo_launch failed: cudaError {err}")
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
    out_bf16 = _acc_flag(acc_dtype)
    kw = dict(fmt_name=fmt_name, block_size=block_size, acc_dtype=acc_dtype,
              bk=bk)
    if _device(a_elems, a_scales, b_elems, b_scales).type == "cpu":
        return mx_matmul_vv_plain(a_elems, a_scales, b_elems, b_scales, **kw)
    ae, asc = _bytes(a_elems), a_scales.contiguous()
    be, bs = _bytes(b_elems), b_scales.contiguous()
    out = torch.empty((m, n), dtype=acc_dtype, device=a_elems.device)
    err = _library().mx_matmul_vv_launch(
        ae.data_ptr(), asc.data_ptr(), be.data_ptr(), bs.data_ptr(),
        out.data_ptr(), m, n, k, a_elems.shape[1], bk, block_size,
        F.FORMAT_IDS[fmt_name], out_bf16,
        torch.cuda.current_stream(a_elems.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_matmul_vv_launch failed: cudaError {err}")
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
    dy, be, bs = dy.contiguous(), _bytes(b_elems), b_scales.contiguous()
    m = dy.shape[0]
    dx = torch.empty((m, k), dtype=torch.float32, device=dy.device)
    err = _library().mx_matmul_dgrad_launch(
        dy.data_ptr(), be.data_ptr(), bs.data_ptr(), dx.data_ptr(), m, n, k,
        b_elems.shape[1], bn, block_size, F.FORMAT_IDS[fmt_name],
        torch.cuda.current_stream(dy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_matmul_dgrad_launch failed: cudaError {err}")
    mx_matmul_dgrad.launches += 1
    return dx


#: CUDA launches of each kernel (the plain CPU versions are not counted)
mx_matmul_wo.launches = 0
mx_matmul_vv.launches = 0
mx_matmul_dgrad.launches = 0
