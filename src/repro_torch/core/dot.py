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

``qat_matmul`` is the training product of the MX QAT recipe: both
operands block-quantized at every call (activations along their last
axis, the f32 master weight along d_in) by the fused quantize kernel
(``kernels.ops.quantize_pallas``: the CUDA kernel on CUDA tensors, its
plain version on CPU tensors), multiplied dequantized, with a
straight-through backward over the quantized values. ``fake_quant`` is
the weight-only recipe's straight-through fake quantization.
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


# ---------------------------------------------------------------------------
# quantization-aware training
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``a (..., K) @ b (K, N)``, or batched ``a (E, N, K) @ b (E, K, F)``,
    summed in f32 and rounded once to ``out_dtype``: the reference's
    ``dot_general`` with a ``preferred_element_type``. bf16 operands on
    the card run cuBLAS's bf16 product with an f32 output, rounded here,
    so no cuBLAS setting moves the rounding point; other operands, and
    every CPU tensor, the f32 product of the widened operands (exact for
    bf16 values). f32 products on the card need TF32 off (PyTorch's
    default), else this raises."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        if b.ndim == 3:
            y = torch.bmm(a, b, out_dtype=torch.float32)
        else:
            y = torch.mm(a.reshape(-1, a.shape[-1]), b,
                         out_dtype=torch.float32).reshape(
                *a.shape[:-1], b.shape[-1])
        return y.to(out_dtype)
    if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dot.matmul: f32 products on the card need "
                           "torch.backends.cuda.matmul.allow_tf32 off")
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(
        out_dtype)


def quantize_acts(x: torch.Tensor, fmt: str, block_size: int) -> MXTensor:
    """``x (..., K)`` block-quantized along K by the fused quantize kernel
    (#6 on CUDA tensors; its plain version on CPU tensors)."""
    from repro_torch.kernels import ops  # lazy: kernels import core

    return ops.quantize_pallas(x, fmt, block_size)


def quantize_weight(w: torch.Tensor, fmt: str, block_size: int) -> MXTensor:
    """An f32 master ``(d_in, d_out)`` block-quantized along d_in by the
    fused quantize kernel, through its transpose: an axis-0 MXTensor
    stores its elements ``(d_out, d_in)`` (the reference's
    ``_mx_fsdp_quantize`` off a mesh: ``quantize(w, fmt, bs, axis=0)``)."""
    t = quantize_acts(w.t().contiguous(), fmt, block_size)
    return MXTensor(elements=t.elements, scales=t.scales, fmt_name=t.fmt_name,
                    block_size=block_size, axis=0, shape=tuple(w.shape))


def _qat_fwd(x, w, fmt, block_size, quantize_acts_, mode, acc_dtype):
    """The reference's ``_qat_fwd``: residuals in bf16 for bf16 inputs,
    else f32; ``y`` in ``x``'s dtype. Under ``mode="pallas"`` the product
    is ``mx_dot``'s kernel tier on the MX operands: #10 (``mx_matmul_vv``)
    with quantized activations, #9 (``mx_matmul_wo``) without."""
    res_dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    w_mx = quantize_weight(w, fmt, block_size)
    wq = w_mx.dequantize(res_dtype)
    if quantize_acts_:
        x_mx = quantize_acts(x, fmt, block_size)
        xq = x_mx.dequantize(res_dtype)
    else:
        x_mx, xq = x, x
    if mode == "fused" and acc_dtype == torch.float32:
        # mx_dot's fused product: bf16 operands (the residuals where they
        # are bf16: MX values are exact in bf16), f32 sums, here rounded
        # once to y's dtype
        def wide(t, mx):
            return t if t.dtype == torch.bfloat16 else _as_wide(
                mx, mode, torch.bfloat16)

        y = matmul(wide(xq, x_mx), wide(wq, w_mx), x.dtype)
    else:
        y = mx_dot(x_mx, w_mx, mode=mode, acc_dtype=acc_dtype).to(x.dtype)
    return y, xq, wq


class _QATMatmul(torch.autograd.Function):
    """Forward :func:`_qat_fwd`; backward the reference's ``_qat_bwd``:
    ``dx = dy @ wq^T`` in the operand dtype, ``dw = xq^T @ dy`` in f32,
    straight through the quantizers."""

    @staticmethod
    def forward(ctx, x, w, fmt, block_size, quantize_acts_, mode,
                acc_dtype):
        y, xq, wq = _qat_fwd(x, w, fmt, block_size, quantize_acts_, mode,
                             acc_dtype)
        ctx.save_for_backward(xq, wq)
        return y

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        op_dtype = xq.dtype  # bf16 in training graphs, f32 in exact tests
        dy = dy.to(op_dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul(dy, wq.t(), op_dtype)
        if ctx.needs_input_grad[1]:
            dw = matmul(xq.reshape(-1, xq.shape[-1]).t(),
                        dy.reshape(-1, dy.shape[-1]), torch.float32)
        return dx, dw, None, None, None, None, None


def qat_matmul(x: torch.Tensor, w: torch.Tensor, fmt: str = "fp8_e4m3",
               block_size: int = 32, quantize_acts: bool = True,
               mode: str = "fused", acc_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` through MX quantization with a straight-through backward
    (port of ``repro.core.dot.qat_matmul`` off a mesh).

    The f32 master ``w (d_in, d_out)`` and, with ``quantize_acts``, ``x``
    are block-quantized afresh at every call, both at ``fmt`` as in the
    reference; the backward multiplies the quantized values. ``mode`` is
    ``mx_dot``'s: "emulated", "fused" or "pallas", whose forward runs
    ``kernels.ops.mx_matmul`` on the MX operands (#10, or #9 without
    ``quantize_acts``, on CUDA tensors; their plain versions on CPU
    tensors). The backward does not depend on the mode. ``nn.linear``
    maps "pallas" to "fused", as ``repro.nn.linear`` does, so only a
    direct call runs the kernel tier. On CUDA tensors both quantizations
    launch #6 (``kernels.mx_quantize``)."""
    if mode not in MODES:
        raise ValueError(f"qat_matmul takes a mode of {MODES}, not "
                         f"{mode!r}")
    return _QATMatmul.apply(x, w, fmt, block_size, quantize_acts, mode,
                            acc_dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt, block_size, axis):
        return quantize_value(x, fmt, block_size, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(x: torch.Tensor, fmt: str, block_size: int,
               axis: int = -1) -> torch.Tensor:
    """Fake quantization of one tensor with the reference's
    straight-through gradient (the incoming gradient, unchanged)."""
    return _FakeQuant.apply(x, fmt, block_size, axis)
