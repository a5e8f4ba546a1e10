"""Rotary position embeddings (port of ``repro.nn.rotary``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = 2.0 * torch.arange(head_dim // 2, dtype=torch.float32,
                                  device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x (..., S, H, D)`` by ``positions (..., S)`` (split halves).

    cos/sin are computed in f32, rounded to ``x``'s dtype and applied in
    that dtype, op by op, as the reference does.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
