"""MX element and scale formats (OCP Microscaling v1.0).

Port of ``repro.core.formats``: FP8 E4M3 (``float8_e4m3fn``) and FP8 E5M2
(``float8_e5m2``), FP6 E3M2 / E2M3 (four 6-bit codes packed into three
``uint8`` bytes, low bits first), FP4 E2M1 (two nibbles per ``uint8``
byte, low nibble first), and the E8M0 shared-scale format. The packed
byte layouts are the reference's, so stored bytes compare one for one.

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

    @property
    def packed(self) -> bool:
        """True if two elements are packed per storage byte (FP4)."""
        return self.bits == 4

    @property
    def sub_byte(self) -> bool:
        """True if elements are stored packed below one byte each (FP4/FP6)."""
        return self.bits < 8

    @property
    def bias(self) -> int:
        """IEEE-style exponent bias (2^(exp_bits-1) - 1)."""
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def min_subnormal(self) -> float:
        """Smallest positive magnitude: 2^(1 - bias - mantissa_bits)."""
        return 2.0 ** (1 - self.bias - self.mantissa_bits)

    @property
    def eps(self) -> float:
        """Machine epsilon of the element format (2^-mantissa_bits)."""
        return 2.0 ** (-self.mantissa_bits)

    def storage_len(self, n: int) -> int:
        """Storage entries covering ``n`` logical elements along the packed
        axis (``n`` for FP8, ``n/2`` bytes for FP4, ``3n/4`` bytes for FP6)."""
        if self.bits % 8 == 0:
            return n
        if (n * self.bits) % 8 != 0:
            raise ValueError(
                f"{self.name}: {n} elements do not pack into whole bytes")
        return n * self.bits // 8


FP8_E4M3 = ElementFormat(name="fp8_e4m3", bits=8, exp_bits=4,
                         mantissa_bits=3, emax=8, max=448.0,
                         storage_dtype=torch.float8_e4m3fn)

FP8_E5M2 = ElementFormat(name="fp8_e5m2", bits=8, exp_bits=5,
                         mantissa_bits=2, emax=15, max=57344.0,
                         storage_dtype=torch.float8_e5m2)

FP6_E3M2 = ElementFormat(name="fp6_e3m2", bits=6, exp_bits=3,
                         mantissa_bits=2, emax=4, max=28.0,
                         storage_dtype=torch.uint8)

FP6_E2M3 = ElementFormat(name="fp6_e2m3", bits=6, exp_bits=2,
                         mantissa_bits=3, emax=2, max=7.5,
                         storage_dtype=torch.uint8)

FP4_E2M1 = ElementFormat(name="fp4_e2m1", bits=4, exp_bits=2,
                         mantissa_bits=1, emax=2, max=6.0,
                         storage_dtype=torch.uint8)

FORMATS = {f.name: f for f in (FP8_E4M3, FP8_E5M2, FP6_E3M2, FP6_E2M3,
                               FP4_E2M1)}

#: stable numeric format ids, wide to narrow (the CUDA kernels' ``fmt``
#: argument, see ``kernels/csrc/mx_codec.cuh``)
FORMAT_IDS = {"fp8_e4m3": 0, "fp8_e5m2": 1, "fp6_e3m2": 2, "fp6_e2m3": 3,
              "fp4_e2m1": 4}
FORMAT_BY_ID = {v: k for k, v in FORMAT_IDS.items()}


def get_format(fmt) -> ElementFormat:
    if isinstance(fmt, ElementFormat):
        return fmt
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
    """Exact RNE snap of finite f32 values onto a format's grid.

    The quantum 2^(e - mantissa_bits) comes from the exponent field, and
    ``x / q`` is rounded half-to-even; a plain cast could double-round.
    Generic over (exp_bits, mantissa_bits), so it serves FP8, FP6 and FP4
    alike. The caller clips to the finite range first. Returns f32.
    """
    fmt = get_format(fmt)
    xf = x.to(torch.float32)
    ax = xf.abs()
    e = floor_log2(ax)
    min_norm_exp = 2 - 2 ** (fmt.exp_bits - 1)  # e4m3 -6, e5m2 -14, e2m1 0
    e = e.clamp(min=min_norm_exp)
    q = _pow2_from_exponent(e - fmt.mantissa_bits)
    y = torch.round(xf / q) * q  # x/q exact (power of two); round is RNE
    return torch.where(ax == 0, xf, y)


def cast_to_format_value(x: torch.Tensor, fmt) -> torch.Tensor:
    """Cast to the element format and back to f32 (the quantization grid)."""
    fmt = get_format(fmt)
    return snap_to_fp8_grid(x.to(torch.float32).clamp(-fmt.max, fmt.max),
                            fmt)


# ---------------------------------------------------------------------------
# FP4 / FP6 codes (storage space): [sign | exp_bits | mantissa_bits]
# ---------------------------------------------------------------------------


def _encode_codes(x: torch.Tensor, fmt: ElementFormat) -> torch.Tensor:
    """f32 values -> sub-byte codes (uint8), RNE + saturate.

    The value is snapped onto the grid, then the code fields are
    recovered arithmetically; exact, because a grid point's fields divide
    out by powers of two. The sign bit follows the input's sign, zeros
    included.
    """
    x = x.to(torch.float32)
    v = cast_to_format_value(x, fmt)
    sign = (v < 0) | ((v == 0) & torch.signbit(x))
    mag = v.abs()
    e = floor_log2(mag)
    is_norm = mag >= 2.0 ** (1 - fmt.bias)
    e_field = torch.where(is_norm, e + fmt.bias, torch.zeros_like(e))
    e_norm = torch.where(is_norm, e, torch.zeros_like(e))  # keeps 2^e finite
    quantum = torch.where(is_norm,
                          _pow2_from_exponent(e_norm - fmt.mantissa_bits),
                          torch.full_like(mag, fmt.min_subnormal))
    frac = mag - torch.where(is_norm, _pow2_from_exponent(e_norm),
                             torch.zeros_like(mag))
    m = torch.round(frac / quantum).to(torch.int32)
    code = (e_field << fmt.mantissa_bits) | m
    code = torch.where(sign, code | (1 << (fmt.bits - 1)), code)
    return code.to(torch.uint8)


def _decode_codes(code: torch.Tensor, fmt: ElementFormat) -> torch.Tensor:
    """Sub-byte codes (uint8) -> f32 values (exact)."""
    c = code.to(torch.int32)
    m = (c & ((1 << fmt.mantissa_bits) - 1)).to(torch.float32)
    e_field = (c >> fmt.mantissa_bits) & ((1 << fmt.exp_bits) - 1)
    scale = _pow2_from_exponent(e_field - fmt.bias)
    mag = torch.where(e_field == 0, m * fmt.min_subnormal,
                      (1.0 + m * fmt.eps) * scale)
    neg = (c & (1 << (fmt.bits - 1))) != 0
    return torch.where(neg, -mag, mag)


def fp4_encode(x: torch.Tensor) -> torch.Tensor:
    """Encode f32 values to E2M1 nibbles (uint8 in [0, 15]), RNE + saturate."""
    return _encode_codes(x, FP4_E2M1)


def fp4_decode(code: torch.Tensor) -> torch.Tensor:
    """Decode E2M1 nibbles (uint8 in [0, 15]) to f32 values."""
    return _decode_codes(code, FP4_E2M1)


def fp4_pack(nibbles: torch.Tensor) -> torch.Tensor:
    """Pack pairs of nibbles along the last axis: (..., 2n) -> (..., n).

    Element ``2i`` goes to the low nibble, ``2i+1`` to the high nibble.
    """
    if nibbles.shape[-1] % 2 != 0:
        raise ValueError("fp4_pack needs an even-sized last axis")
    lo = nibbles[..., 0::2].to(torch.int32)
    hi = nibbles[..., 1::2].to(torch.int32)
    return ((lo | (hi << 4)) & 0xFF).to(torch.uint8)


def fp4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fp4_pack`: (..., n) -> (..., 2n) nibbles."""
    p = packed.to(torch.int32)
    codes = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    return codes.reshape(*packed.shape[:-1], -1).to(torch.uint8)


def fp6_encode(x: torch.Tensor, fmt) -> torch.Tensor:
    """Encode f32 values to 6-bit FP6 codes (uint8 in [0, 63]), RNE +
    saturate."""
    fmt = get_format(fmt)
    if fmt.bits != 6:
        raise ValueError(f"fp6_encode got {fmt.name}")
    return _encode_codes(x, fmt)


def fp6_decode(code: torch.Tensor, fmt) -> torch.Tensor:
    """Decode 6-bit FP6 codes (uint8 in [0, 63]) to f32 values."""
    fmt = get_format(fmt)
    if fmt.bits != 6:
        raise ValueError(f"fp6_decode got {fmt.name}")
    return _decode_codes(code, fmt)


def fp6_pack(codes: torch.Tensor) -> torch.Tensor:
    """Pack quads of 6-bit codes along the last axis: (..., 4n) -> (..., 3n).

    Little-endian bit order: code ``4i`` occupies the low 6 bits of byte
    ``3i``, and each following code continues in the next-higher bits.
    """
    if codes.shape[-1] % 4 != 0:
        raise ValueError("fp6_pack needs a multiple-of-4 last axis")
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], -1, 4)
    c0, c1, c2, c3 = c.unbind(-1)
    packed = torch.stack([c0 | (c1 << 6), (c1 >> 2) | (c2 << 4),
                          (c2 >> 4) | (c3 << 2)], dim=-1) & 0xFF
    return packed.reshape(*codes.shape[:-1], -1).to(torch.uint8)


def fp6_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fp6_pack`: (..., 3n) -> (..., 4n) codes."""
    if packed.shape[-1] % 3 != 0:
        raise ValueError("fp6_unpack needs a multiple-of-3 last axis")
    b = packed.to(torch.int32).reshape(*packed.shape[:-1], -1, 3)
    b0, b1, b2 = b.unbind(-1)
    codes = torch.stack([b0, (b0 >> 6) | (b1 << 2), (b1 >> 4) | (b2 << 4),
                         b2 >> 2], dim=-1) & 0x3F
    return codes.reshape(*packed.shape[:-1], -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# storage encode/decode for any format
# ---------------------------------------------------------------------------


def encode_elements(x: torch.Tensor, fmt) -> torch.Tensor:
    """f32 values -> storage (fp8 dtype, or packed ``uint8`` for FP4/FP6)."""
    fmt = get_format(fmt)
    if fmt.bits == 4:
        return fp4_pack(fp4_encode(x))
    if fmt.bits == 6:
        return fp6_pack(fp6_encode(x, fmt))
    # exact: the snapped value is on the grid (clip first: torch's e5m2
    # cast overflows to inf where the reference saturates)
    return cast_to_format_value(x, fmt).to(fmt.storage_dtype)


def decode_elements(stored: torch.Tensor, fmt,
                    dtype=torch.float32) -> torch.Tensor:
    """Storage -> values in ``dtype`` (the last axis grows 2x for FP4 and
    4/3x for FP6)."""
    fmt = get_format(fmt)
    if fmt.bits == 4:
        return fp4_decode(fp4_unpack(stored)).to(dtype)
    if fmt.bits == 6:
        return fp6_decode(fp6_unpack(stored), fmt).to(dtype)
    return stored.to(dtype)


def e8m0_factor(e_biased: torch.Tensor) -> torch.Tensor:
    """The factor a decode multiplies a block's elements by: the scale,
    with byte 0's subnormal 2^-127 read as zero, as the reference's
    flushed arithmetic reads that operand (a normal code times 2^-127
    can be a normal value)."""
    return flush_subnormals(e8m0_to_scale(e_biased))


def dequantize_blocks(stored: torch.Tensor, scales: torch.Tensor, fmt,
                      block_size: int) -> torch.Tensor:
    """MX storage ``(..., storage_len(K))`` + E8M0 ``(..., K/k)`` -> f32
    ``(..., K)``: decode, fold each block's power-of-two scale in (exact),
    flush subnormal results (the reference's ``_fold_scales``)."""
    vals = decode_elements(stored, fmt)
    blocked = vals.reshape(*vals.shape[:-1], scales.shape[-1], block_size)
    wide = blocked * e8m0_factor(scales)[..., None]
    return flush_subnormals(wide).reshape(vals.shape)
