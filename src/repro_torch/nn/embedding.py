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


def embed(params, tokens: torch.Tensor, compute_dtype=torch.bfloat16, *,
          scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    """Table rows of ``tokens``; with ``scale_by_sqrt_dim`` times
    ``bf16(d_model) ** 0.5`` rounded to the compute dtype, the product
    rounded to it too, as the reference's narrow multiply."""
    x = params["embed"].to(compute_dtype)[tokens]
    if scale_by_sqrt_dim:
        d = torch.tensor(float(params["embed"].shape[-1]),
                         dtype=compute_dtype)
        x = x * (d ** 0.5).item()
    return x


def logits(params, x: torch.Tensor, compute_dtype=torch.bfloat16, *,
           softcap=None) -> torch.Tensor:
    """Hidden states -> vocab logits: the bf16 product as f32, then with
    ``softcap`` ``tanh(out / softcap) * softcap`` in f32
    (``host_math.softcap``: XLA:CPU's bits on CPU tensors)."""
    w = params["head"] if "head" in params else params["embed"].T
    out = torch.matmul(x.to(compute_dtype), w.to(compute_dtype)).to(
        torch.float32)
    return host_math.softcap(out, softcap) if softcap else out
