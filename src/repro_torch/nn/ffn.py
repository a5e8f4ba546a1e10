"""Gated feed-forward blocks (port of ``repro.nn.ffn``): SwiGLU and
GeGLU. The no-gate ``gelu`` kind (musicgen) waits for ROADMAP A8d."""
from __future__ import annotations

import torch

from repro_torch.core import QuantConfig, host_math
from repro_torch.core.formats import flush_subnormals

from . import common as C
from . import linear


def init(gen: torch.Generator, d_model: int, d_ff: int, quant: QuantConfig,
         device) -> dict:
    return {"gate": linear.init(gen, d_model, d_ff, quant, device),
            "up": linear.init(gen, d_model, d_ff, quant, device),
            "down": linear.init(gen, d_ff, d_model, quant, device)}


def init_train(gen: torch.Generator, d_model: int, d_ff: int,
               device) -> dict:
    """f32 master projections (the training path)."""
    return {"gate": linear.init_master(gen, d_model, d_ff, device),
            "up": linear.init_master(gen, d_model, d_ff, device),
            "down": linear.init_master(gen, d_ff, d_model, device)}


def silu(g: torch.Tensor) -> torch.Tensor:
    """``g * sigmoid(g)`` in f32 with the reference's flush of subnormals
    written out: sigmoid underflows to subnormals below about -87, and the
    product is subnormal for tiny ``g``."""
    return flush_subnormals(g * flush_subnormals(torch.sigmoid(g)))


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(g, approximate=True)`` of f32 ``g``: on CPU tensors
    XLA:CPU's bits (``host_math.gelu_tanh``); on the card the same formula
    in torch's f32 ops and ``tanh``, subnormals flushed."""
    if g.device.type == "cpu":
        return host_math.gelu_tanh(g)
    g = flush_subnormals(g)
    u = (g + g * g * g * 0.044715) * 0.7978845834732056
    return flush_subnormals(g * ((torch.tanh(u) + 1.0) * 0.5))


ACTIVATIONS = {"swiglu": silu, "geglu": gelu_tanh}


def apply(params, x: torch.Tensor, kind: str = "swiglu",
          compute_dtype=torch.bfloat16, quant=None) -> torch.Tensor:
    """The gated FFN; ``quant`` as in ``linear.apply`` (None for prepared
    serving weights, the config's policy for f32 training masters)."""
    up = linear.apply(params["up"], x, compute_dtype, quant)
    gate = linear.apply(params["gate"], x, compute_dtype, quant)
    act = ACTIVATIONS[kind](gate.to(torch.float32))
    # the product of two bf16 values is exact in f32, so one rounding
    # gives the reference's narrow-multiply semantics
    h = C.round_to(C.round_to(act, compute_dtype).to(torch.float32)
                   * up.to(torch.float32), compute_dtype)
    return linear.apply(params["down"], h, compute_dtype, quant)
