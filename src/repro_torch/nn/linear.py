"""MX-aware linear layers (port of ``repro.nn.linear``).

Four kinds of weight reach :func:`apply`:

  * a prepared weight (the serving path): the reference keeps f32 master
    weights and fake-quantizes them inside every step
    (``core.dot.fake_quant`` along the input axis), then runs a bf16
    product that accumulates in f32 and rounds once (``_dot_rounded``).
    The port fake-quantizes each weight ONCE, when it is loaded or
    initialised (:func:`prepare_weight`), into bf16: the same values the
    reference recomputes per step, at half the memory of f32 masters;
  * a wide weight under ``quant.enabled=False``: the same bf16 product;
  * an f32 master (the training path, :func:`init_master`) under an
    enabled ``quant``: with ``quant.quantize_acts``, the reference's
    ``qat_matmul`` (both operands block-quantized at every call, #6 on
    CUDA tensors, straight-through backward); without it, the
    straight-through ``fake_quant`` of the weight along d_in, then that
    product;
  * an ``MXTensor`` from :func:`quantize_weights`: ``core.dot.mx_dot`` in
    ``quant.mode``, with wide bf16 activations (weight-only) or, under
    ``quant.quantize_acts``, activations block-quantized to
    ``quant.activation_format`` (MX x MX). ``mode="pallas"`` launches the
    CUDA kernels on CUDA tensors and runs their plain versions on CPU
    tensors; there is no fallback to another mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import (MXTensor, QuantConfig, fake_quant, mx_dot,
                              qat_matmul, quantize)

from . import common as C


def prepare_weight(w: torch.Tensor, quant: QuantConfig,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """f32 master ``(d_in, d_out)`` -> the bf16 weight ``apply`` multiplies
    when serving. Serving is weight-only (the reference's launcher sets
    ``quantize_acts=False``); a QAT policy trains f32 masters instead
    (:func:`init_master`)."""
    if not quant.enabled or quant.quantize_acts:
        raise NotImplementedError(
            "prepared weights are weight-only MX; quantize_acts=True "
            "trains f32 masters (init_master)")
    wq = fake_quant(w.to(torch.float32), quant.fmt, quant.block_size, 0)
    return wq.to(compute_dtype)


def init(gen: torch.Generator, d_in: int, d_out: int, quant: QuantConfig,
         device, scale: float = 1.0, compute_dtype=torch.bfloat16) -> dict:
    w = C.truncated_normal_init(gen, (d_in, d_out), scale, device)
    return {"w": prepare_weight(w, quant, compute_dtype)}


def init_master(gen: torch.Generator, d_in: int, d_out: int, device,
                scale: float = 1.0) -> dict:
    """An f32 master weight for training, as the reference's init."""
    return {"w": C.truncated_normal_init(gen, (d_in, d_out), scale, device)}


def apply(params, x: torch.Tensor, compute_dtype=torch.bfloat16,
          quant: Optional[QuantConfig] = None) -> torch.Tensor:
    """``x @ w`` under the quantization policy (see the module docstring);
    prepared weights pass ``quant=None``."""
    w = params["w"]
    if isinstance(w, MXTensor):
        if quant is None:
            raise ValueError("MXTensor weights need the QuantConfig")
        y = mx_dot(_activations(x, quant, compute_dtype), w, mode=quant.mode,
                   acc_dtype=quant.acc_dtype)
        return y.to(compute_dtype)
    if quant is not None and quant.enabled:
        if quant.quantize_acts:
            y = qat_matmul(x.to(compute_dtype), w.to(torch.float32),
                           quant.fmt, quant.block_size, True,
                           "fused" if quant.mode == "pallas" else quant.mode,
                           quant.acc_dtype)
            return y.to(compute_dtype)
        w = fake_quant(w.to(torch.float32), quant.fmt, quant.block_size, 0)
    return _dot_rounded(x.to(compute_dtype), w.to(compute_dtype),
                        compute_dtype)


def _activations(x: torch.Tensor, quant: QuantConfig, compute_dtype):
    if not quant.enabled:
        return x.to(compute_dtype)
    if quant.quantize_acts:
        return quantize(x.to(torch.float32), quant.activation_format,
                        quant.block_size)
    return x.to(torch.bfloat16)


def _dot_rounded(x: torch.Tensor, w: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """bf16 ``x @ w`` accumulated in f32 and rounded once at the output.

    On the card this holds only with cuBLAS's reduced-precision bf16
    reduction and TF32 off, which the serving engine sets at
    construction and ``model.forward`` at each call
    (``common.exact_cuda_products``).
    """
    return torch.matmul(x, w).to(compute_dtype)


def quantize_weights(params, quant: QuantConfig):
    """Wide weight leaves -> ``MXTensor`` blocked along d_in (stored
    (d_out, d_in), the kernels' column-major B)."""
    if not quant.enabled:
        return params
    return {"w": quantize(params["w"].to(torch.float32), quant.fmt,
                          quant.block_size, axis=0)}
