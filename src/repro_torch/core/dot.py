"""MX products (port of ``repro.core.dot``): only ``fake_quant``, the
forward of the weight-only serving path. ``mx_dot`` and ``qat_matmul``
wait for the MX matmul kernels (ROADMAP B7)."""
from __future__ import annotations

import torch

from .quantize import quantize_value


def fake_quant(x: torch.Tensor, fmt: str, block_size: int,
               axis: int = -1) -> torch.Tensor:
    """Fake quantization of one tensor (forward only; the reference's
    straight-through gradient is a training concern)."""
    return quantize_value(x, fmt, block_size, axis)
