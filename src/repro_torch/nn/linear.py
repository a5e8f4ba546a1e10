"""MX-aware linear layers (port of ``repro.nn.linear``), weight-only path.

The reference keeps f32 master weights and fake-quantizes them inside
every step (``core.dot.fake_quant`` along the input axis), then runs a
bf16 product that accumulates in f32 and rounds once (``_dot_rounded``).
The port fake-quantizes each weight ONCE, when it is loaded or
initialised (:func:`prepare_weight`), into bf16: the same values the
reference recomputes per step, at half the memory of f32 masters.
"""
from __future__ import annotations

import torch

from repro_torch.core import QuantConfig, fake_quant

from . import common as C


def prepare_weight(w: torch.Tensor, quant: QuantConfig,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """f32 master ``(d_in, d_out)`` -> the bf16 weight ``apply`` multiplies."""
    if not quant.enabled or quant.quantize_acts:
        raise NotImplementedError(
            "only weight-only MX linears are ported (ROADMAP A1/A3); set "
            "quantize_acts=False")
    wq = fake_quant(w.to(torch.float32), quant.fmt, quant.block_size, 0)
    return wq.to(compute_dtype)


def init(gen: torch.Generator, d_in: int, d_out: int, quant: QuantConfig,
         device, scale: float = 1.0, compute_dtype=torch.bfloat16) -> dict:
    w = C.truncated_normal_init(gen, (d_in, d_out), scale, device)
    return {"w": prepare_weight(w, quant, compute_dtype)}


def apply(params, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` on a prepared weight."""
    return _dot_rounded(x.to(compute_dtype), params["w"], compute_dtype)


def _dot_rounded(x: torch.Tensor, w: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """bf16 ``x @ w`` accumulated in f32 and rounded once at the output.

    On the card this holds only with cuBLAS's reduced-precision bf16
    reduction and TF32 off, which the serving engine sets at
    construction.
    """
    return torch.matmul(x, w).to(compute_dtype)
