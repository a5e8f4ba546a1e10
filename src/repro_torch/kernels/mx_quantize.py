"""Fused MX block quantization (port of ``repro.kernels.mx_quantize``).

:func:`mx_quantize` turns wide rows ``x (M, K)`` (f32 or bf16) into MX
elements ``(M, storage_len(K))`` and E8M0 scales ``(M, K // block_size)``
in one pass, for all five element formats. On CUDA tensors it launches
the hand-written kernel in ``csrc/mx_quantize.cu``; on CPU tensors it
runs :func:`mx_quantize_plain`. :func:`quantize_rows` is the shared
arithmetic of every quantizing kernel's plain version (this one and the
ragged page write), as ``csrc/mx_codec.cuh`` is for the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F

from . import build

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mx_quantize")
        fn = lib.mx_quantize_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def quantize_rows(x: torch.Tensor, fmt: F.ElementFormat, block_size: int):
    """(..., K) f32 -> (storage bytes (..., storage_len(K)) uint8, E8M0
    scales (..., K // block_size) uint8).

    The reference's in-kernel quantizer (``_mx_quantize_kernel``):
    exponent-field floor-log2 of the block amax (not frexp), E8M0 clipped
    to [0, 254], the ratio clipped to the format's range and encoded RNE,
    with the reference's flushed subnormals (``formats.flush_subnormals``;
    E8M0 byte 0 encodes the whole block as +0).
    """
    x = F.flush_subnormals(x.to(torch.float32))
    k = x.shape[-1]
    blocked = x.reshape(*x.shape[:-1], k // block_size, block_size)
    amax = blocked.abs().amax(dim=-1)
    e_unb = F.floor_log2(amax) - fmt.emax + F.E8M0_BIAS
    e = torch.where(amax > 0, e_unb, torch.zeros_like(e_unb))
    e = e.clamp(0, 254).to(torch.uint8)
    scale = F.e8m0_to_scale(e)[..., None]
    ratio = torch.where(e[..., None] > 0, blocked / scale,
                        torch.zeros_like(blocked))
    ratio = ratio.clamp(-fmt.max, fmt.max).reshape(x.shape)
    return F.encode_elements(ratio, fmt).view(torch.uint8), e


def mx_quantize_plain(x: torch.Tensor, *, fmt_name: str = "fp8_e4m3",
                      block_size: int = 32):
    """PyTorch version of the kernel: ``(elements, scales)`` of ``x``,
    elements in the format's storage dtype."""
    fmt = F.get_format(fmt_name)
    elems, scales = quantize_rows(x, fmt, block_size)
    return elems.view(fmt.storage_dtype), scales


def _launch(x: torch.Tensor, fmt: F.ElementFormat, block_size: int):
    m, k = x.shape
    if not (block_size <= 32 and 32 % block_size == 0
            or block_size % 32 == 0):
        raise ValueError(
            f"the CUDA quantizer takes block sizes that divide 32 or are "
            f"multiples of 32, not {block_size}")
    ek = fmt.storage_len(k)
    elems = torch.empty((m, ek), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, k // block_size), dtype=torch.uint8,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().mx_quantize_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), elems.data_ptr(),
        scales.data_ptr(), m, k, ek, block_size, F.FORMAT_IDS[fmt.name],
        stream)
    if err != 0:
        raise RuntimeError(f"mx_quantize_launch failed: cudaError {err}")
    mx_quantize.launches += 1
    return elems.view(fmt.storage_dtype), scales


def mx_quantize(x: torch.Tensor, *, fmt_name: str = "fp8_e4m3",
                block_size: int = 32):
    """Quantize ``x (M, K)`` along K. Returns ``(elements, e8m0_scales)``.

    ``x`` is f32 or bf16; ``block_size`` divides K, and K packs into
    whole bytes (even for fp4, a multiple of 4 for fp6). CUDA tensors
    launch the CUDA kernel (counted in ``mx_quantize.launches``); CPU
    tensors run :func:`mx_quantize_plain`.
    """
    fmt = F.get_format(fmt_name)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    k = x.shape[1]
    if k % block_size:
        raise ValueError(f"block_size {block_size} does not divide {k}")
    fmt.storage_len(k)  # raises unless K packs into whole bytes
    if x.device.type == "cuda":
        return _launch(x.contiguous(), fmt, block_size)
    if x.device.type == "cpu":
        return mx_quantize_plain(x, fmt_name=fmt.name, block_size=block_size)
    raise NotImplementedError(f"no quantize kernel for device {x.device}")


#: CUDA launches of the kernel (the plain CPU version is not counted)
mx_quantize.launches = 0
