"""Token embedding + LM head (port of ``repro.nn.embedding``), with
gemma2's embedding scale and final logit softcap.

Tables are stored in the compute dtype (bf16): the reference keeps f32
masters and casts them at every use, which gives the same values.
"""
from __future__ import annotations

import torch

from repro_torch.core import host_math

from . import common as C


def init(gen: torch.Generator, vocab: int, d_model: int, tied: bool,
         device, dtype=torch.bfloat16) -> dict:
    embed = torch.randn((vocab, d_model), generator=gen, device=device)
    params = {"embed": (embed * 0.01).to(dtype)}
    if not tied:
        params["head"] = C.truncated_normal_init(
            gen, (d_model, vocab), 1.0, device).to(dtype)
    return params


def init_train(gen: torch.Generator, vocab: int, d_model: int, tied: bool,
               device) -> dict:
    """f32 master tables (the training path), as the reference's init:
    ``normal * 0.01``, and an untied head ``truncated_normal``."""
    embed = torch.randn((vocab, d_model), generator=gen, device=device)
    params = {"embed": embed.mul_(0.01)}
    if not tied:
        params["head"] = C.truncated_normal_init(gen, (d_model, vocab), 1.0,
                                                 device)
    return params


def scatter_add_rows(rows: torch.Tensor, index: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """A zero ``(num_rows, D)`` table in ``rows``' dtype with each row
    ``rows[i]`` added at ``index[i]``, one at a time in the order of i,
    each add rounded to that dtype: the reference's scatter-add, the
    transpose of its gather. Deterministic on every device: the adds go
    in passes, pass r adding every index's r-th occurrence, and the rows
    of one pass are distinct (no atomics)."""
    out = torch.zeros((num_rows, rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    order = torch.argsort(index, stable=True)
    ids = index[order]
    rank = (torch.arange(ids.numel(), device=ids.device)
            - torch.searchsorted(ids, ids))
    for r in range(int(rank.max()) + 1 if ids.numel() else 0):
        sel = rank == r
        at = ids[sel]
        out[at] = out[at] + rows[order[sel]]
    return out


class _Gather(torch.autograd.Function):
    """``table[tokens]`` whose backward is :func:`scatter_add_rows` in the
    table's dtype (PyTorch's own index backward accumulates with atomics
    on the card, in no fixed order)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.num_rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        return scatter_add_rows(g.reshape(-1, g.shape[-1]),
                                tokens.reshape(-1), ctx.num_rows), None


def _sqrt_dim(params, compute_dtype) -> float:
    """``bf16(d_model) ** 0.5`` in the compute dtype (48 at 2,304, 59.75
    at 3,584), the reference's embedding scale."""
    d = torch.tensor(float(params["embed"].shape[-1]), dtype=compute_dtype)
    return (d ** 0.5).item()


def embed_train(params, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
                *, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    """Rows of the f32 master table cast to the compute dtype, with the
    deterministic scatter-add backward (:class:`_Gather`); with
    ``scale_by_sqrt_dim`` times :func:`_sqrt_dim` in the compute dtype,
    as :func:`embed`."""
    x = _Gather.apply(params["embed"].to(compute_dtype), tokens.long())
    return x * _sqrt_dim(params, compute_dtype) if scale_by_sqrt_dim else x


def embed(params, tokens: torch.Tensor, compute_dtype=torch.bfloat16, *,
          scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    """Table rows of ``tokens``; with ``scale_by_sqrt_dim`` times
    ``bf16(d_model) ** 0.5`` rounded to the compute dtype, the product
    rounded to it too, as the reference's narrow multiply."""
    x = params["embed"].to(compute_dtype)[tokens]
    return x * _sqrt_dim(params, compute_dtype) if scale_by_sqrt_dim else x


def _xla_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` of bf16 values summed in f32 in XLA:CPU's
    order (``host_math.matmul``: one chain of fused multiply-adds at the
    head's shapes), rounded to bf16."""
    return host_math.matmul(a.float(), b.float()).to(a.dtype)


class _HeadCPU(torch.autograd.Function):
    """The head's bf16 product ``x (M, d) @ w (d, V)`` on CPU tensors and
    its two gradients, each summed in XLA:CPU's order
    (:func:`_xla_mm`): torch's CPU product sums in another, which moves
    a bf16 rounding at about one logit in 16,000 (reduced musicgen)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _xla_mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = _xla_mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            # laid out as w (the tied table's transpose), as torch's own
            # product's gradient is: the optimizer reads it flat
            dw = torch.empty_like(w).copy_(_xla_mm(x.t(), g))
        return dx, dw


def logits(params, x: torch.Tensor, compute_dtype=torch.bfloat16, *,
           softcap=None) -> torch.Tensor:
    """Hidden states -> vocab logits: the bf16 product as f32 (on CPU
    tensors summed in XLA:CPU's order, :class:`_HeadCPU`), then with
    ``softcap`` ``tanh(out / softcap) * softcap`` in f32
    (``host_math.softcap``: XLA:CPU's bits on CPU tensors)."""
    w = params["head"] if "head" in params else params["embed"].T
    x, w = x.to(compute_dtype), w.to(compute_dtype)
    if x.device.type == "cpu":
        out = _HeadCPU.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])
    else:
        out = torch.matmul(x, w)
    out = out.to(torch.float32)
    return host_math.softcap(out, softcap) if softcap else out
