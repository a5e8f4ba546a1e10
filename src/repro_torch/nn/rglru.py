"""RG-LRU recurrent block with its temporal convolution (port of
``repro.nn.rglru``; RecurrentGemma / Griffin).

The recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` is
diagonal and associative: prefill runs it as the reference's
``jax.lax.associative_scan`` does, the same odd/even recursion on tensors
(:func:`_associative_scan`, O(log S) ops a layer on the card too), so the
sums combine in the reference's order; decode is one state update. The
state is ``{"h": (B, W) f32, "conv": (B, conv_width - 1, W) f32}``, O(width)
a sequence whatever its length.

The projections run through ``linear.apply`` (prepared MX weights, bf16
products); the convolution, the gates and the recurrence stay in f32, the
gates' W x W products included (``gate_a`` and ``gate_x`` are f32 weights,
not MX). On CPU tensors the f32 math takes XLA:CPU's bits from
``core.host_math``: its exp, sigmoid and softplus, its f32 dot (one chain
of fused multiply-adds) and the multiply-adds it contracts (the scan's
``a2 * b1 + b2``, the convolution's taps). On the card the same formulas
run in torch's f32 ops with TF32 off.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import host_math

from . import common as C
from . import linear
from .ffn import gelu_tanh

_C_RGLRU = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    width: int  # lru width (recurrentgemma: == d_model)
    conv_width: int = 4


def init(gen: torch.Generator, cfg: RGLRUConfig, quant, device) -> dict:
    """Random weights from ``gen`` in the reference's shapes: MX
    projections, an f32 convolution and f32 W x W gates; ``lam`` is the
    reference's ``linspace(0.9, 5.0, W)``, so that ``a^c`` spans about
    [0.9, 0.999]."""
    w = cfg.width
    return {
        "proj_x": linear.init(gen, cfg.d_model, w, quant, device),
        "proj_gate": linear.init(gen, cfg.d_model, w, quant, device),
        "proj_out": linear.init(gen, w, cfg.d_model, quant, device),
        "conv_w": C.truncated_normal_init(gen, (cfg.conv_width, w), 1.0,
                                          device),
        "conv_b": torch.zeros((w,), dtype=torch.float32, device=device),
        "gate_a": C.truncated_normal_init(gen, (w, w), 1.0, device),
        "gate_x": C.truncated_normal_init(gen, (w, w), 1.0, device),
        "gate_a_b": torch.zeros((w,), dtype=torch.float32, device=device),
        "gate_x_b": torch.zeros((w,), dtype=torch.float32, device=device),
        "lam": torch.linspace(0.9, 5.0, w, dtype=torch.float32,
                              device=device),
    }


def _cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _fma(a, b, c):
    """``a * b + c``: one rounding on CPU tensors (XLA:CPU contracts it),
    torch's two on the card."""
    return host_math.fma(a, b, c) if _cpu(c) else a * b + c


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w`` for x (..., W): XLA:CPU's dot order on CPU tensors;
    torch's f32 product on the card (TF32 off, ``exact_cuda_products``)."""
    if _cpu(x):
        return host_math.dot(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])
    return torch.matmul(x, w)


def _sigmoid(x):
    return host_math.logistic(x) if _cpu(x) else torch.sigmoid(x)


def _softplus(x):
    if _cpu(x):
        return host_math.softplus(x)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _exp(x):
    return host_math.exp(x) if _cpu(x) else torch.exp(x)


def _gates(params, xc: torch.Tensor, split: bool = False) -> tuple:
    """Recurrence coefficients (a, sqrt(1 - a^2) * i * xc) from the f32
    convolution output ``xc``; with ``split`` the second as its factors
    (sqrt(1 - a^2) * i, xc)."""
    r = _sigmoid(_matmul_f32(xc, params["gate_a"]) + params["gate_a_b"])
    i = _sigmoid(_matmul_f32(xc, params["gate_x"]) + params["gate_x_b"])
    log_a = -_C_RGLRU * _softplus(params["lam"]) * r
    a = _exp(log_a)
    # sqrt(1 - a^2) through the log, as the reference computes it
    mult = torch.sqrt(torch.clamp_min(1.0 - _exp(2.0 * log_a), 1e-12))
    return (a, (mult * i, xc)) if split else (a, mult * i * xc)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's shifted-sum causal convolution of (B, S, C) f32 by
    taps ``w`` (CW, C), without its bias: tap i reads x shifted by ``CW -
    1 - i``, the taps summed in order. XLA:CPU fuses the loop and
    contracts the first add's left product (``fma(s0, w0, s1 * w1)``),
    then each later tap into the running sum; torch's ops on the card."""
    cw, s = w.shape[0], x.shape[1]
    taps = [torch.nn.functional.pad(x, (0, 0, cw - 1 - i, 0))[:, :s]
            for i in range(cw)]
    if cw == 1:
        return taps[0] * w[0]
    out = _fma(taps[0], w[0], taps[1] * w[1])
    for i in range(2, cw):
        out = _fma(taps[i], w[i], out)
    return out


def _conv_full(params, x: torch.Tensor) -> torch.Tensor:
    """Causal temporal convolution of (B, S, W) f32, plus its bias."""
    return (causal_conv(x, params["conv_w"].to(torch.float32))
            + params["conv_b"].to(torch.float32))


def _combine(c1: tuple, c2: tuple) -> tuple:
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, _fma(a2, b1, b2)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elements of ``a`` and ``b`` alternating along axis 1, a first
    (``len(a)`` is ``len(b)`` or one more)."""
    n = a.shape[1] + b.shape[1]
    out = a.new_empty((a.shape[0], n, *a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(elems: tuple) -> tuple:
    """``jax.lax.associative_scan(_combine, elems, axis=1)`` in the same
    recursion, so every sum associates as the reference's: combine
    adjacent pairs, scan those, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:n - 1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd),
                        tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _scan(params, xr: torch.Tensor) -> torch.Tensor:
    """The hidden states h (B, S, W) f32 of the projected input ``xr``."""
    a, b_term = _gates(params, _conv_full(params, xr))
    _, h = _associative_scan((a, b_term))
    return h


def _merge(params, h: torch.Tensor, gate: torch.Tensor, dt) -> torch.Tensor:
    """``h`` gated by GELU(gate), each rounded to ``dt``, then the output
    projection."""
    merged = h.to(dt) * gelu_tanh(gate.to(torch.float32)).to(dt)
    return linear.apply(params["proj_out"], merged, dt)


def apply_train(params, x: torch.Tensor, cfg: RGLRUConfig,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The full-sequence recurrent branch over x (B, S, d_model):
    convolution, RG-LRU scan, gated merge (the prefill's forward)."""
    xr = linear.apply(params["proj_x"], x, compute_dtype).to(torch.float32)
    gate = linear.apply(params["proj_gate"], x, compute_dtype)
    return _merge(params, _scan(params, xr), gate, compute_dtype)


def init_state(batch: int, cfg: RGLRUConfig, device) -> dict:
    return {"h": torch.zeros((batch, cfg.width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.width),
                                dtype=torch.float32, device=device)}


def _conv_step(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bcw,cw->bw", hist, w)``: on CPU tensors XLA:CPU's order,
    the taps summed in order, with the multiply-adds fused from 4 rows
    (its einsum of one row adds the rounded products; 2 and 3 rows sum in
    an order not reproduced here, within an f32 ulp); a sum of the
    products on the card."""
    if not _cpu(hist):
        return torch.einsum("bcw,cw->bw", hist, w)
    out = hist[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        out = (out + hist[:, i] * w[i] if hist.shape[0] == 1
               else host_math.fma(hist[:, i], w[i], out))
    return out


def apply_decode(params, x: torch.Tensor, state: dict, cfg: RGLRUConfig,
                 compute_dtype=torch.bfloat16,
                 scanned: bool = True) -> torch.Tensor:
    """One token x (B, 1, d_model) against ``state``, which is updated in
    place (every row, as the reference's step). Returns (B, 1, d_model).
    ``scanned``: whether the reference runs this layer inside its scan
    over the pattern, which decides the multiply-add XLA:CPU contracts in
    the update (CPU tensors)."""
    xr = linear.apply(params["proj_x"], x, compute_dtype).to(
        torch.float32)[:, 0]
    gate = linear.apply(params["proj_gate"], x, compute_dtype)[:, 0]
    w = params["conv_w"].to(torch.float32)
    hist = torch.cat([state["conv"], xr[:, None]], dim=1)
    xc = _conv_step(hist, w) + params["conv_b"]
    a, (mi, xc) = _gates(params, xc, split=True)
    # XLA:CPU contracts the input term's product inside the scan of the
    # model's jitted step, fma(mult * i, xc, a * h), and the state term's
    # in an unscanned layer (and a standalone step), fma(a, h, mult * i *
    # xc)
    h = (_fma(mi, xc, a * state["h"]) if scanned
         else _fma(a, state["h"], mi * xc))
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return _merge(params, h[:, None], gate[:, None], compute_dtype)


def _final_state(h: torch.Tensor, xr: torch.Tensor, cw: int) -> dict:
    s = xr.shape[1]
    conv = (xr[:, s - (cw - 1):] if s >= cw - 1 else
            torch.nn.functional.pad(xr, (0, 0, cw - 1 - s, 0)))
    return {"h": h[:, -1].contiguous(), "conv": conv.contiguous()}


def prefill_state(params, x: torch.Tensor, cfg: RGLRUConfig,
                  compute_dtype=torch.bfloat16) -> dict:
    """The final recurrent and convolution state after the sequence x (B,
    S, d_model): the last hidden state and the last ``conv_width - 1``
    projected inputs, zero-padded in front for a shorter prompt."""
    xr = linear.apply(params["proj_x"], x, compute_dtype).to(torch.float32)
    return _final_state(_scan(params, xr), xr, cfg.conv_width)


def prefill(params, x: torch.Tensor, cfg: RGLRUConfig,
            compute_dtype=torch.bfloat16) -> tuple:
    """(:func:`apply_train`, :func:`prefill_state`) of x from one scan:
    the values the reference's prefill computes twice."""
    xr = linear.apply(params["proj_x"], x, compute_dtype).to(torch.float32)
    gate = linear.apply(params["proj_gate"], x, compute_dtype)
    h = _scan(params, xr)
    return (_merge(params, h, gate, compute_dtype),
            _final_state(h, xr, cfg.conv_width))
