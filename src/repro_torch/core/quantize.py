"""Block quantization to MX formats (port of ``repro.core.quantize``).

Split the array into blocks of ``block_size`` along ``axis``, derive one
E8M0 exponent per block from the block amax, and cast the scaled
elements with RNE + saturation. The work dtype is always f32. The
reference quantizes bf16 inputs in bf16, which gives the same codes:
the block amax and the division by a power-of-two scale are exact in
bf16, and the clip bounds of every format are bf16 values
(``tests/test_torch_formats.py`` checks this bit for bit).
"""
from __future__ import annotations

import torch

from . import formats as F
from .mx_tensor import MXTensor


def quantize(x: torch.Tensor, fmt="fp8_e4m3", block_size: int = 32,
             axis: int = -1) -> MXTensor:
    fmt = F.get_format(fmt)
    logical_shape = tuple(x.shape)
    axis = axis % x.ndim
    xl = F.flush_subnormals(torch.movedim(x.to(torch.float32), axis, -1))
    k = xl.shape[-1]
    if k % block_size != 0:
        raise ValueError(
            f"block_size {block_size} does not divide axis length {k}")
    blocked = xl.reshape(*xl.shape[:-1], k // block_size, block_size)
    amax = blocked.abs().amax(dim=-1)
    e_biased = F.e8m0_from_amax(amax, fmt)
    scale = F.e8m0_to_scale(e_biased)[..., None]
    # E8M0 byte 0 decodes to the subnormal 2^-127, which the reference's
    # flushed ``scale > 0`` reads as zero: the whole block encodes +0.
    # Testing the byte gives that result on every device.
    ratio = torch.where(e_biased[..., None] > 0, blocked / scale,
                        torch.zeros_like(blocked))
    elements = F.encode_elements(ratio.reshape(xl.shape), fmt)
    return MXTensor(elements=elements, scales=e_biased, fmt_name=fmt.name,
                    block_size=block_size, axis=axis, shape=logical_shape)


def dequantize(t: MXTensor, dtype=torch.float32) -> torch.Tensor:
    return t.dequantize(dtype)


def quantize_value(x: torch.Tensor, fmt="fp8_e4m3", block_size: int = 32,
                   axis: int = -1) -> torch.Tensor:
    """Fake-quantize: quantize then dequantize, back in ``x``'s dtype."""
    return quantize(x, fmt, block_size, axis).dequantize(x.dtype)
