"""Public entry points of the MX kernels (port of ``repro.kernels.ops``).

``mx_matmul`` takes ``MXTensor`` or wide operands with any leading batch
dims and dispatches to the MX x MX or the weight-only kernel;
``quantize_pallas`` makes an ``MXTensor`` with the fused quantize kernel;
``mx_matmul_trainable`` is the weight-only product whose backward runs
the dgrad kernel. The names are the reference's, so tests and readers
find each counterpart; "pallas" there names the hand-written-kernel tier,
here the CUDA kernels (on CUDA tensors) or their plain PyTorch versions
(on CPU tensors).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.mx_tensor import MXTensor

from . import mx_matmul as _mm
from . import mx_quantize as _mq


def _tile(dim: int, pref: int) -> int:
    """Largest divisor of ``dim`` that is <= pref (tries hw-aligned first)."""
    for cand in (pref, 512, 256, 128, 64, 32, 16, 8):
        if cand <= pref and dim % cand == 0:
            return cand
    return dim


def mx_matmul(a, b: MXTensor, *, acc_dtype=torch.float32,
              out_dtype=None) -> torch.Tensor:
    """``a (..., K) @ b (K, N)`` with MX semantics through the kernels.

    ``b`` must be an MXTensor blocked along K (axis 0, stored (N, K): the
    paper's column-major layout). ``a`` is either an MXTensor blocked
    along its last axis (MX x MX) or a wide tensor (weight-only). Each
    partial sum covers the reference's K tile, ``_tile(K, 512)``.
    """
    if not isinstance(b, MXTensor) or b.axis != 0:
        raise ValueError("b must be an MXTensor blocked along axis 0 (K)")
    k, n = b.shape
    if a.shape[-1] != k:
        raise ValueError(f"a has K = {a.shape[-1]}, b has K = {k}")
    block_size = b.block_size
    bk = max(_tile(k, 512), block_size)
    if isinstance(a, MXTensor):
        if a.axis not in (-1, len(a.shape) - 1):
            raise ValueError("a must be blocked along its last axis")
        if a.block_size != block_size or a.fmt_name != b.fmt_name:
            raise ValueError("operand quantization configs differ")
        lead = tuple(a.shape[:-1])
        m = math.prod(lead)
        out = _mm.mx_matmul_vv(
            a.elements.reshape(m, -1), a.scales.reshape(m, -1), b.elements,
            b.scales, fmt_name=b.fmt_name, block_size=block_size,
            acc_dtype=acc_dtype, bk=bk)
    else:
        lead = tuple(a.shape[:-1])
        out = _mm.mx_matmul_wo(
            a.reshape(math.prod(lead), k), b.elements, b.scales,
            fmt_name=b.fmt_name, block_size=block_size, acc_dtype=acc_dtype,
            bk=bk)
    return out.reshape(*lead, n).to(out_dtype or acc_dtype)


def quantize_pallas(x: torch.Tensor, fmt_name: str = "fp8_e4m3",
                    block_size: int = 32) -> MXTensor:
    """Block quantization of ``x (..., K)`` along its last axis by the
    fused quantize kernel (the name is the reference's: it means "the
    fused quantize kernel", here CUDA)."""
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    elems, scales = _mq.mx_quantize(x.reshape(math.prod(lead), k),
                                    fmt_name=fmt_name, block_size=block_size)
    return MXTensor(elements=elems.reshape(*lead, elems.shape[-1]),
                    scales=scales.reshape(*lead, k // block_size),
                    fmt_name=fmt_name, block_size=block_size, axis=len(lead),
                    shape=tuple(x.shape))


class _MXMatmulTrainable(torch.autograd.Function):
    """Weight-only kernel forward; dx through the dgrad kernel backward."""

    @staticmethod
    def forward(ctx, x, w_mx, fmt, block_size, acc_dtype):
        ctx.w_mx = w_mx
        ctx.x_dtype = x.dtype
        return mx_matmul(x, w_mx, acc_dtype=acc_dtype)

    @staticmethod
    def backward(ctx, dy):
        w_mx = ctx.w_mx
        dy32 = dy.to(torch.float32)
        lead = tuple(dy32.shape[:-1])
        n = dy32.shape[-1]
        k = w_mx.shape[0]
        # the stored (N, K) MX layout is already W^T: no wide weight copy
        dx = _mm.mx_matmul_dgrad(
            dy32.reshape(math.prod(lead), n), w_mx.elements, w_mx.scales,
            fmt_name=w_mx.fmt_name, block_size=w_mx.block_size,
            bn=_tile(n, 128))
        # no gradient for the MX weight: it is not a differentiable leaf
        # (the reference returns a zero cotangent for it)
        return dx.reshape(*lead, k).to(ctx.x_dtype), None, None, None, None


def mx_matmul_trainable(x: torch.Tensor, w_mx: MXTensor, fmt: str,
                        block_size: int, acc_dtype=torch.float32):
    """Weight-only MX product with a differentiable wide backward:
    ``dx = dy @ dequant(W)^T`` by the dgrad kernel, no weight gradient."""
    return _MXMatmulTrainable.apply(x, w_mx, fmt, block_size, acc_dtype)
