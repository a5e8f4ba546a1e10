"""Rotary position embeddings (port of ``repro.nn.rotary``).

Both tables are built on the host and moved to the device once, so every
device rotates with the same bits: the reference's frequencies are what
XLA folds its expression into at compile time, which no f32 ``pow``
reproduces; its f32 cos/sin are the C library's ``cosf``/``sinf``
(``core.host_math``), which torch's CPU cos/sin miss at long positions;
and a CUDA card's f32 cos/sin differ from the CPU's in the last bits often
enough to move a bf16 rounding (``chip_smoke.py`` counts those places on
an H100).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import host_math


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """The reference's ``1 / theta ** (2i / head_dim)`` as its jitted
    function gives it, bit for bit: ``theta ** -(i * f32(2 / head_dim))``
    raised in f64 and rounded once to f32 (a CPU tensor)."""
    exponent = (np.arange(head_dim // 2, dtype=np.float32)
                * np.float32(2.0 / head_dim)).astype(np.float64)
    freqs = np.power(np.float64(np.float32(theta)), -exponent)
    return torch.from_numpy(freqs.astype(np.float32))


@functools.lru_cache(maxsize=None)
def rope_table(head_dim: int, theta: float, num_positions: int,
               device) -> tuple:
    """f32 ``(cos, sin)`` of the angles ``position * freq`` (one f32
    multiply) at positions ``[0, num_positions)``, each (num_positions,
    head_dim // 2): the C library's ``cosf``/``sinf`` on the host, as the
    jitted reference gets them, moved to ``device``. Shared: do not
    modify."""
    angles = (torch.arange(num_positions, dtype=torch.float32)[:, None]
              * rope_freqs(head_dim, theta))
    cos, sin = host_math.cos_sin(angles)
    return cos.to(device), sin.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               num_positions: int) -> torch.Tensor:
    """Rotate ``x (..., S, H, D)`` by ``positions (..., S)`` (split halves).

    Positions index the host-made table of ``num_positions`` entries
    (out of range raises, on the card as a device-side assert). cos/sin
    are rounded to ``x``'s dtype and applied in that dtype, op by op, as
    the reference does.
    """
    cos, sin = rope_table(x.shape[-1], float(theta), num_positions, x.device)
    idx = positions.long()
    cos = cos[idx][..., None, :].to(x.dtype)
    sin = sin[idx][..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
