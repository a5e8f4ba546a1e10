"""MX element and scale formats (OCP Microscaling v1.0), fp8 subset.

Port of ``repro.core.formats`` for the fp8 element formats the serving
path stores: FP8 E4M3 (``float8_e4m3fn``) and FP8 E5M2
(``float8_e5m2``), plus the E8M0 shared-scale format. FP6/FP4 are not
ported yet (ROADMAP A1); asking for them raises ``NotImplementedError``.

All casts are round-to-nearest-even with saturation, computed in f32 with
exponent-field bit tricks so they are exact on every device.
"""
from __future__ import annotations

import dataclasses

import torch

E8M0_BIAS = 127


@dataclasses.dataclass(frozen=True)
class ElementFormat:
    """Static description of an MX element format."""

    name: str
    bits: int
    exp_bits: int
    mantissa_bits: int
    emax: int  # largest unbiased exponent of a finite value
    max: float  # largest finite magnitude
    storage_dtype: torch.dtype  # torch dtype used to store encoded elements


FP8_E4M3 = ElementFormat(name="fp8_e4m3", bits=8, exp_bits=4,
                         mantissa_bits=3, emax=8, max=448.0,
                         storage_dtype=torch.float8_e4m3fn)

FP8_E5M2 = ElementFormat(name="fp8_e5m2", bits=8, exp_bits=5,
                         mantissa_bits=2, emax=15, max=57344.0,
                         storage_dtype=torch.float8_e5m2)

FORMATS = {f.name: f for f in (FP8_E4M3, FP8_E5M2)}

#: formats of the reference that this package does not implement yet
UNPORTED_FORMATS = ("fp6_e3m2", "fp6_e2m3", "fp4_e2m1")


def get_format(fmt) -> ElementFormat:
    if isinstance(fmt, ElementFormat):
        return fmt
    if fmt in UNPORTED_FORMATS:
        raise NotImplementedError(
            f"{fmt} is not ported to repro_torch yet (ROADMAP A1: fp4/fp6 "
            "encoders and packing)")
    return FORMATS[fmt]


#: smallest normal f32 magnitude; f32 values below it are subnormal
F32_MIN_NORMAL = 2.0 ** -126


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values -> zero of the same sign.

    The reference computes with denormals flushed (XLA:CPU and the TPU
    both treat subnormal operands and results as signed zero). The port
    writes that flush out where it can change a stored byte or a
    dequantized value, so every device agrees without a flush-to-zero
    mode (the CUDA kernels are built without ``-ftz``).
    """
    return torch.where(x.abs() < F32_MIN_NORMAL, x * 0.0, x)


def _pow2_from_exponent(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (f32) for integer tensors e in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of positive normal f32 values from the exponent field.

    Subnormals and zero read as -127: this is the kernels' floor-log2
    (``mx_quantize._floor_log2`` in the reference), which differs from
    frexp below the normal range.
    """
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


# ---------------------------------------------------------------------------
# E8M0 scale format
# ---------------------------------------------------------------------------


def e8m0_from_amax(amax: torch.Tensor, fmt: ElementFormat) -> torch.Tensor:
    """Biased E8M0 shared exponent for a block with absolute maximum ``amax``.

    ``floor(log2(amax)) - emax`` with an exact frexp floor-log2 (correct
    for subnormal amax too), clipped to [0, 254]; amax == 0 gives 0.
    """
    amax = amax.to(torch.float32)
    _, exp = torch.frexp(amax)  # amax = m * 2^exp, m in [0.5, 1)
    biased = exp.to(torch.int32) - 1 - fmt.emax + E8M0_BIAS
    biased = torch.where(amax > 0, biased, torch.zeros_like(biased))
    return biased.clamp(0, 254).to(torch.uint8)


def e8m0_to_scale(e_biased: torch.Tensor) -> torch.Tensor:
    """Decode biased E8M0 exponents to f32 power-of-two scales.

    The exponent byte goes straight into the f32 exponent field, which is
    exact; ``e == 0`` decodes to the subnormal 2^-127 (0x00400000).
    """
    e = e_biased.to(torch.int32)
    bits = torch.where(e > 0, e << 23, torch.full_like(e, 0x00400000))
    return bits.view(torch.float32)


# ---------------------------------------------------------------------------
# element casts (value space)
# ---------------------------------------------------------------------------


def snap_to_fp8_grid(x: torch.Tensor, fmt) -> torch.Tensor:
    """Exact RNE snap of finite f32 values onto the fp8 grid (value space).

    The quantum 2^(e - mantissa_bits) comes from the exponent field, and
    ``x / q`` is rounded half-to-even; a plain cast could double-round.
    The caller clips to the finite range first. Returns f32.
    """
    fmt = get_format(fmt)
    xf = x.to(torch.float32)
    ax = xf.abs()
    e = floor_log2(ax)
    min_norm_exp = 2 - 2 ** (fmt.exp_bits - 1)  # e4m3: -6, e5m2: -14
    e = e.clamp(min=min_norm_exp)
    q = _pow2_from_exponent(e - fmt.mantissa_bits)
    y = torch.round(xf / q) * q  # x/q exact (power of two); round is RNE
    return torch.where(ax == 0, xf, y)


def encode_elements(x: torch.Tensor, fmt) -> torch.Tensor:
    """f32 values -> fp8 storage (RNE + saturation)."""
    fmt = get_format(fmt)
    snapped = snap_to_fp8_grid(x.to(torch.float32).clamp(-fmt.max, fmt.max),
                               fmt)
    return snapped.to(fmt.storage_dtype)  # exact: the value is on the grid


def decode_elements(stored: torch.Tensor, fmt,
                    dtype=torch.float32) -> torch.Tensor:
    get_format(fmt)
    return stored.to(dtype)
