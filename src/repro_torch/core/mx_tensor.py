"""MXTensor: block-scaled elements + E8M0 scales (port of
``repro.core.mx_tensor``). The blocked axis is stored last; ``axis``
records where it lives in the logical (dequantized) array."""
from __future__ import annotations

import dataclasses

import torch

from . import formats as F


@dataclasses.dataclass
class MXTensor:
    elements: torch.Tensor  # (..., K) fp8 storage, blocked axis last
    scales: torch.Tensor  # (..., K // block_size) uint8 biased E8M0
    fmt_name: str = "fp8_e4m3"
    block_size: int = 32
    axis: int = -1
    shape: tuple = ()

    @property
    def num_blocks(self) -> int:
        return self.elements.shape[-1] // self.block_size

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reconstruct the wide array: ``elements * 2^(scales - 127)``."""
        vals = F.decode_elements(self.elements, self.fmt_name)
        blocked = vals.reshape(*vals.shape[:-1], self.num_blocks,
                               self.block_size)
        wide = F.flush_subnormals(
            blocked * F.e8m0_to_scale(self.scales)[..., None]
        ).reshape(vals.shape)
        if self.axis not in (-1, wide.ndim - 1):
            wide = torch.movedim(wide, -1, self.axis)
        return wide.to(dtype)
