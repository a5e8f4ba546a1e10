"""Token sampling (port of ``repro.serve.sampling``): greedy only.

Temperature 0 takes the exact f32 argmax of each row, first index on
ties, as ``jnp.argmax`` does. Stochastic sampling needs the reference's
counter-based threefry streams to give the same tokens and is not ported
yet (ROADMAP A2): asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

UNPORTED = ("stochastic sampling (temperature > 0) is not ported to "
            "repro_torch yet (ROADMAP A2: the reference's counter-based "
            "threefry streams)")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (greedy only in the port)."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: Optional[int] = None

    def validate(self) -> "SamplingParams":
        if not np.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.temperature > 0:
            raise NotImplementedError(UNPORTED)
        return self


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(N, V) logits -> (N,) int64 argmax in f32, first index on ties."""
    return torch.argmax(logits.to(torch.float32), dim=-1)


def top2_gap_ulps(logits: torch.Tensor) -> torch.Tensor:
    """(N, V) logits -> (N,) lead of each row's top logit over its
    runner-up, in bf16 ulps of the top logit (logits are bf16 values, so
    a gap of 0 is an exact tie)."""
    top2 = logits.to(torch.float32).topk(2, dim=-1).values
    exponent = torch.frexp(top2[:, 0].abs()).exponent
    return (top2[:, 0] - top2[:, 1]) / torch.ldexp(
        torch.ones_like(top2[:, 0]), exponent - 8)
