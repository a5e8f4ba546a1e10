"""Feed-forward blocks (port of ``repro.nn.ffn``): the gated SwiGLU and
GeGLU, and musicgen's no-gate ``gelu`` (the tanh GELU of the up
projection alone)."""
from __future__ import annotations

import torch

from repro_torch.core import QuantConfig, host_math
from repro_torch.core.formats import flush_subnormals

from . import common as C
from . import linear


def _check_kind(kind: str) -> None:
    if kind not in ACTIVATIONS:
        raise ValueError(f"unknown ffn kind {kind!r} (expected one of "
                         f"{sorted(ACTIVATIONS)})")


def init(gen: torch.Generator, d_model: int, d_ff: int, quant: QuantConfig,
         device, kind: str = "swiglu") -> dict:
    """Random prepared projections; the ``gelu`` kind has no ``gate``."""
    _check_kind(kind)
    params = {"gate": linear.init(gen, d_model, d_ff, quant, device)} \
        if kind in GATED else {}
    return {**params, "up": linear.init(gen, d_model, d_ff, quant, device),
            "down": linear.init(gen, d_ff, d_model, quant, device)}


def init_train(gen: torch.Generator, d_model: int, d_ff: int, device,
               kind: str = "swiglu") -> dict:
    """f32 master projections (the training path); no ``gate`` for the
    ``gelu`` kind."""
    _check_kind(kind)
    params = {"gate": linear.init_master(gen, d_model, d_ff, device)} \
        if kind in GATED else {}
    return {**params,
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


#: each kind's activation: of the gate (the gated kinds), or of the up
#: projection itself (``gelu``)
ACTIVATIONS = {"swiglu": silu, "geglu": gelu_tanh, "gelu": gelu_tanh}
#: the kinds with a gate projection
GATED = ("swiglu", "geglu")


def apply(params, x: torch.Tensor, kind: str = "swiglu",
          compute_dtype=torch.bfloat16, quant=None) -> torch.Tensor:
    """The FFN of ``kind``; ``quant`` as in ``linear.apply`` (None for
    prepared serving weights, the config's policy for f32 training
    masters). The gated kinds multiply ``bf16(act(gate))`` by ``up``;
    ``gelu`` takes ``bf16(gelu_tanh(up))``. Gradients flow through every
    kind, through the same bf16 roundings (a cast's backward rounds the
    gradient to the cast's source dtype, as the reference's
    ``reduce_precision`` and ``astype`` transpose), and on CPU tensors
    through XLA:CPU's tanh (``host_math.gelu_tanh``)."""
    _check_kind(kind)
    up = linear.apply(params["up"], x, compute_dtype, quant)
    if kind not in GATED:
        h = C.round_to(gelu_tanh(up.to(torch.float32)), compute_dtype)
        return linear.apply(params["down"], h, compute_dtype, quant)
    gate = linear.apply(params["gate"], x, compute_dtype, quant)
    act = ACTIVATIONS[kind](gate.to(torch.float32))
    # the product of two bf16 values is exact in f32, so one rounding
    # gives the reference's narrow-multiply semantics
    h = C.round_to(C.round_to(act, compute_dtype).to(torch.float32)
                   * up.to(torch.float32), compute_dtype)
    return linear.apply(params["down"], h, compute_dtype, quant)
