"""MXTensor: block-scaled elements + E8M0 scales (port of
``repro.core.mx_tensor``). The blocked axis is stored last; ``axis``
records where it lives in the logical (dequantized) array."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import formats as F


@dataclasses.dataclass
class MXTensor:
    """Block-scaled tensor: ``elements`` (narrow FP) + E8M0 ``scales``.

    ``elements`` is (..., K) fp8 storage, or (..., K/2) packed ``uint8``
    for FP4 and (..., 3K/4) for FP6; ``scales`` is (..., K // block_size)
    ``uint8`` biased E8M0. ``shape`` is the logical (dequantized) shape.
    """

    elements: torch.Tensor
    scales: torch.Tensor
    fmt_name: str = "fp8_e4m3"
    block_size: int = 32
    axis: int = -1
    shape: tuple = ()

    @property
    def fmt(self) -> F.ElementFormat:
        return F.get_format(self.fmt_name)

    @property
    def k(self) -> int:
        """Logical length of the blocked axis."""
        return self.shape[self.axis]

    @property
    def num_blocks(self) -> int:
        return self.k // self.block_size

    @property
    def nbytes(self) -> int:
        """Storage footprint in bytes (elements + scales)."""
        return (self.elements.numel() * self.elements.element_size()
                + self.scales.numel())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reconstruct the wide array: ``elements * 2^(scales - 127)``."""
        wide = F.dequantize_blocks(self.elements, self.scales, self.fmt,
                                   self.block_size)
        if self.axis not in (-1, wide.ndim - 1):
            wide = torch.movedim(wide, -1, self.axis)
        return wide.to(dtype)


def from_jax(elements: np.ndarray, scales: np.ndarray, fmt_name: str,
             block_size: int, axis: int, shape: tuple,
             device="cpu") -> MXTensor:
    """The reference's ``MXTensor`` fields, as numpy arrays, as the port's.

    fp8 elements arrive in an ml_dtypes float8 dtype: their bytes are
    viewed as ``uint8`` and then as the matching ``torch.float8_*``;
    packed FP4/FP6 bytes are ``uint8`` already.
    """
    fmt = F.get_format(fmt_name)
    raw = torch.from_numpy(np.array(elements).view(np.uint8))  # a copy
    return MXTensor(elements=raw.view(fmt.storage_dtype).to(device),
                    scales=torch.from_numpy(np.array(scales, np.uint8)).to(
                        device),
                    fmt_name=fmt.name, block_size=block_size, axis=axis,
                    shape=tuple(shape))
