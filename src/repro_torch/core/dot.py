"""MX dot products: the software execution modes of the VMXDOTP study
(port of ``repro.core.dot``).

Three modes mirror the paper's three tiers:

  * ``emulated``: MX as a storage-only format. Elements are decoded to
    f32, the block scales expanded and applied in a second step, then a
    plain f32 product.
  * ``fused``: one dequantize expression into bf16 operands, then a
    product that accumulates in f32.
  * ``pallas``: the hand-written-kernel tier (the reference's name for
    its Pallas kernels): ``kernels.ops.mx_matmul``, whose CUDA kernels
    read the compact MX bytes and fold the scales in registers. On CPU
    tensors it runs the kernels' plain PyTorch versions.

``qat_matmul`` and its backward wait for the training slice.
"""
from __future__ import annotations

from typing import Union

import torch

from .mx_tensor import MXTensor
from .quantize import quantize_value

MODES = ("emulated", "fused", "pallas")


def _dequant_two_step(t: MXTensor) -> torch.Tensor:
    """Emulated path: decode, then apply the block scales, in f32."""
    return t.dequantize(torch.float32)


def _dequant_fused(t: MXTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Single-expression dequant into a narrow dtype."""
    return t.dequantize(dtype)


def _as_wide(x: Union[torch.Tensor, MXTensor], mode: str,
             dtype) -> torch.Tensor:
    if isinstance(x, MXTensor):
        if mode == "emulated":
            return _dequant_two_step(x)
        return _dequant_fused(x, dtype)
    return x.to(torch.float32 if mode == "emulated" else dtype)


def mx_dot(a: Union[torch.Tensor, MXTensor], b: Union[torch.Tensor, MXTensor],
           *, mode: str = "fused", acc_dtype=torch.float32,
           out_dtype=None) -> torch.Tensor:
    """Contract ``a (..., K) @ b (K, N)`` with MX semantics.

    Either operand may be an :class:`MXTensor` (blocked along the
    contraction axis) or a plain tensor, the paper's vector-scalar
    variants. Products of bf16 operands are exact in f32, so "fused"
    multiplies the bf16 values in f32 and accumulates there.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "pallas":
        from repro_torch.kernels import ops  # lazy: kernels import core

        return ops.mx_matmul(a, b, acc_dtype=acc_dtype, out_dtype=out_dtype)
    operand_dtype = torch.float32 if mode == "emulated" else torch.bfloat16
    aw = _as_wide(a, mode, operand_dtype).to(torch.float32)
    bw = _as_wide(b, mode, operand_dtype).to(torch.float32)
    out = torch.tensordot(aw, bw, dims=([aw.ndim - 1], [0]))
    return out.to(acc_dtype).to(out_dtype or acc_dtype)


def fake_quant(x: torch.Tensor, fmt: str, block_size: int,
               axis: int = -1) -> torch.Tensor:
    """Fake quantization of one tensor (forward only; the reference's
    straight-through gradient is a training concern)."""
    return quantize_value(x, fmt, block_size, axis)
