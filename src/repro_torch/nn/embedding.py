"""Token embedding + LM head (port of ``repro.nn.embedding``).

Tables are stored in the compute dtype (bf16): the reference keeps f32
masters and casts them at every use, which gives the same values.
"""
from __future__ import annotations

import torch

from . import common as C


def init(gen: torch.Generator, vocab: int, d_model: int, tied: bool,
         device, dtype=torch.bfloat16) -> dict:
    embed = torch.randn((vocab, d_model), generator=gen, device=device)
    params = {"embed": (embed * 0.01).to(dtype)}
    if not tied:
        params["head"] = C.truncated_normal_init(
            gen, (d_model, vocab), 1.0, device).to(dtype)
    return params


def embed(params, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return params["embed"].to(compute_dtype)[tokens]


def logits(params, x: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Hidden states -> vocab logits (bf16 product, returned as f32)."""
    w = params["head"] if "head" in params else params["embed"].T
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype)).to(
        torch.float32)
