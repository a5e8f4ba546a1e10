"""Gated feed-forward block (port of ``repro.nn.ffn``): SwiGLU."""
from __future__ import annotations

import torch

from repro_torch.core import QuantConfig
from repro_torch.core.formats import flush_subnormals

from . import common as C
from . import linear


def init(gen: torch.Generator, d_model: int, d_ff: int, quant: QuantConfig,
         device) -> dict:
    return {"gate": linear.init(gen, d_model, d_ff, quant, device),
            "up": linear.init(gen, d_model, d_ff, quant, device),
            "down": linear.init(gen, d_ff, d_model, quant, device)}


def silu(g: torch.Tensor) -> torch.Tensor:
    """``g * sigmoid(g)`` in f32 with the reference's flush of subnormals
    written out: sigmoid underflows to subnormals below about -87, and the
    product is subnormal for tiny ``g``."""
    return flush_subnormals(g * flush_subnormals(torch.sigmoid(g)))


def apply(params, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    up = linear.apply(params["up"], x, compute_dtype)
    gate = linear.apply(params["gate"], x, compute_dtype)
    act = silu(gate.to(torch.float32))
    # the product of two bf16 values is exact in f32, so one rounding
    # gives the reference's narrow-multiply semantics
    h = C.round_to(C.round_to(act, compute_dtype).to(torch.float32)
                   * up.to(torch.float32), compute_dtype)
    return linear.apply(params["down"], h, compute_dtype)
