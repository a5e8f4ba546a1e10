"""RMSNorm with the gemma-style (1 + w) scale (port of ``repro.nn.norms``)."""
from __future__ import annotations

import torch


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6,
                  dtype=None) -> torch.Tensor:
    """RMSNorm in f32 with weight ``1 + scale``, result in ``dtype``
    (default: ``x``'s dtype)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    norm = x32 * torch.rsqrt(var + eps)
    return (norm * (1.0 + params["scale"].to(torch.float32))).to(
        dtype or x.dtype)
