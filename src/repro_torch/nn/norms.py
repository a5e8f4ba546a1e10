"""RMSNorm with the gemma-style (1 + w) scale (port of ``repro.nn.norms``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import host_math

#: XLA:CPU's row sum: windows of this many consecutive elements, each
#: summed in order, level after level (4096 -> 128 -> 4 -> 1)
WINDOW = 32


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def window_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the jitted reference's compiled HLO does:
    reduce-windows of WINDOW consecutive elements, each summed left to
    right, until one value is left. A level whose length is not a multiple
    of WINDOW is padded with zeros split evenly around it, the smaller
    half first (2304 -> 72 -> pad 12 + 12 -> 3 -> 1), as XLA pads it."""
    while v.shape[-1] > 1:
        n = v.shape[-1]
        pad = -n % WINDOW
        if pad:
            lo = pad // 2
            v = torch.nn.functional.pad(v, (lo, pad - lo))
        v = v.reshape(*v.shape[:-1], -1, WINDOW)
        acc = v[..., 0]
        for i in range(1, WINDOW):
            acc = acc + v[..., i]
        v = acc
    return v[..., 0]


def fma_row_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over every axis but the last, as XLA:CPU reduces
    an RMSNorm scale's gradient at small widths: one row after another,
    each product contracted into the running sum (``fma(a, b, acc)``;
    here the exact f64 product and sum, rounded once to f32)."""
    a2 = a.reshape(-1, a.shape[-1]).double()
    b2 = b.reshape(-1, b.shape[-1]).double()
    acc = torch.zeros(a.shape[-1], dtype=torch.float32, device=a.device)
    for i in range(a2.shape[0]):
        acc = (a2[i] * b2[i] + acc.double()).float()
    return acc


class _RMSNormCPU(torch.autograd.Function):
    """The CPU path's ``norm(x32) * (1 + scale)`` in f32, its gradient as
    XLA:CPU computes the jitted reference's: with ``g`` the output's
    gradient, ``w = 1 + scale``, ``u = fma(sum, 1 / width, eps)`` and
    ``r = rsqrt(u)``, the scale's gradient is :func:`fma_row_sum` of ``x *
    r`` and ``g``, and x's is ``(g * w * r + m) + m`` with ``m = x * ((S *
    ((r / u) * -0.5)) * (1 / width))``, ``S`` the :func:`window_sum` of
    ``x * (g * w)``."""

    @staticmethod
    def forward(ctx, x32, scale, eps):
        recip = float(np.float32(1.0) / np.float32(x32.shape[-1]))
        ss = window_sum(x32 * x32)[..., None]
        r = host_math._rsqrt(ss, recip, eps)
        ctx.save_for_backward(x32, scale, ss, r)
        ctx.recip, ctx.eps = recip, eps
        return x32 * r * (1.0 + scale)

    @staticmethod
    def backward(ctx, g):
        x32, scale, ss, r = ctx.saved_tensors
        ct_norm = g * (1.0 + scale)
        d_scale = fma_row_sum(x32 * r, g)
        # u = fma(sum, recip, eps): exact f64 product, one f32 rounding
        u = (ss.double() * ctx.recip + float(np.float32(ctx.eps))).float()
        s = window_sum(x32 * ct_norm)[..., None]
        m = x32 * ((s * ((r / u) * -0.5)) * ctx.recip)
        return (ct_norm * r + m) + m, d_scale, None


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6,
                  dtype=None) -> torch.Tensor:
    """RMSNorm in f32 with weight ``1 + scale``, result in ``dtype``
    (default: ``x``'s dtype).

    On CPU tensors the variance and its rsqrt are the jitted reference's
    bits: :func:`window_sum` of ``x * x``, then XLA:CPU's ``rsqrt`` of
    ``fma(sum, f32(1 / width), eps)`` (XLA folds ``jnp.mean``'s divide
    into that multiply and contracts it with the add;
    ``host_math.rsqrt``, x86 hosts only, raises elsewhere), and its
    gradient is XLA:CPU's (:class:`_RMSNormCPU`).
    On the card one device reduction (``torch.mean``) and ``torch.rsqrt``
    keep the step free of host round trips; ``chip_smoke.py`` counts the
    bf16 outputs where the two paths part."""
    x32 = x.to(torch.float32)
    scale = params["scale"].to(torch.float32)
    if x32.device.type == "cpu":
        return _RMSNormCPU.apply(x32, scale, eps).to(dtype or x.dtype)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    norm = x32 * torch.rsqrt(var + eps)
    return (norm * (1.0 + scale)).to(dtype or x.dtype)
