// MX encode/decode device functions shared by the port's CUDA kernels.
//
// Bit-exact counterparts of repro_torch.core.formats and of the reference's
// in-kernel codecs:
//   * repro/kernels/mx_quantize.py: _floor_log2, _encode_fp4_codes,
//     _pack_fp4, _encode_fp6_codes, _pack_fp6 (and mx_attention.py::
//     _quantize_rows for the fp8 page writes);
//   * repro/kernels/mx_matmul.py: _decode_e8m0, _decode_fp4_codes,
//     _unpack_fp4, _decode_fp6_codes, _unpack_fp6;
//   * repro/kernels/mx_attention.py: _decode_u8_codes and the per-page
//     format select of _dequant_rows_mixed (mixed-format pools).
// The E8M0 shared exponent comes from the block amax by exponent-field
// floor-log2, clipped to [0, 254]; a clipped ratio's code is its value
// rounded to the nearest grid value, ties to even: fp8 by the hardware's
// conversion, fp6 and fp4 from the f32 fields (encode).
//
// The reference runs with denormals flushed, so subnormal inputs and
// products read as signed zero and E8M0 byte 0 (2^-127) acts as a zero
// scale, both when quantizing and when decoding (e8m0_factor). That flush
// is written out here: the kernels are compiled without -ftz.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace mx {

// fmt ids (repro_torch.core.formats.FORMAT_IDS): 0 = fp8 e4m3
// (float8_e4m3fn, no infinities), 1 = fp8 e5m2, 2 = fp6 e3m2, 3 = fp6 e2m3,
// 4 = fp4 e2m1
struct FmtSpec {
  int bits, exp_bits, mant_bits, bias, emax;
  float max;
};

// (constexpr: a kernel templated on the format folds its fields)
__host__ __device__ constexpr FmtSpec fmt_spec(int fmt) {
  switch (fmt) {
    case 0: return FmtSpec{8, 4, 3, 7, 8, 448.0f};
    case 1: return FmtSpec{8, 5, 2, 15, 15, 57344.0f};
    case 2: return FmtSpec{6, 3, 2, 3, 4, 28.0f};
    case 3: return FmtSpec{6, 2, 3, 1, 2, 7.5f};
    default: return FmtSpec{4, 2, 1, 1, 2, 6.0f};
  }
}

constexpr float kMinNormal = 1.17549435e-38f;  // 2^-126

// subnormal -> zero of the same sign (the reference's flushed arithmetic)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kMinNormal ? copysignf(0.0f, x) : x;
}

// a * b with subnormal operands and a subnormal result read as signed
// zero: the reference's flushed product, in one instruction where a kernel
// wants exactly that flush (the build has no -ftz)
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// floor(log2 x) of a non-negative f32 from its exponent field (-127 for
// zero and subnormals)
__device__ __forceinline__ int floor_log2(float x) {
  return static_cast<int>((__float_as_uint(x) >> 23) & 0xFFu) - 127;
}

__device__ __forceinline__ float pow2(int e) {  // exact 2^e, e in [-126, 127]
  return __uint_as_float(static_cast<uint32_t>(e + 127) << 23);
}

__device__ __forceinline__ float e8m0_to_scale(uint8_t e) {
  return __uint_as_float(e > 0 ? static_cast<uint32_t>(e) << 23 : 0x00400000u);
}

// 2^(127-e), the exact reciprocal of e8m0_to_scale(e) for e in [1, 254]
// (2^-127, a subnormal, at 254): x * e8m0_recip(e) is x / 2^(e-127) bit
// for bit, since both round the same real value once (no -ftz); 0 at e = 0
__device__ __forceinline__ float e8m0_recip(uint8_t e) {
  return __uint_as_float(e == 0 ? 0u
                         : e < 254 ? static_cast<uint32_t>(254 - e) << 23
                                   : 0x00400000u);
}

// the factor a decode multiplies a block's elements by: 2^(e-127), with
// byte 0's subnormal 2^-127 read as zero, as the reference's flushed
// arithmetic reads that operand (a normal code times 2^-127 can be normal)
__device__ __forceinline__ float e8m0_factor(uint8_t e) {
  return e > 0 ? __uint_as_float(static_cast<uint32_t>(e) << 23) : 0.0f;
}

__device__ __forceinline__ uint8_t e8m0_from_amax(float amax,
                                                  const FmtSpec& f) {
  int e = amax > 0.0f ? floor_log2(amax) - f.emax + 127 : 0;
  return static_cast<uint8_t>(min(max(e, 0), 254));
}

// fp8 bytes of two ratios already clipped to [-max, max] (a in the low
// byte), by the hardware's RNE conversion (cvt.rn.satfinite.e4m3x2/
// e5m2x2.f32): the reference's fp8 cast, signed zero and subnormal codes
// included (its saturation never acts on a clipped ratio). The one fp8
// encoder of the port: the quantizer packs its words from it, and
// encode() takes its fp8 codes from it.
__device__ __forceinline__ uint32_t fp8_pair(float a, float b,
                                             const FmtSpec& f) {
  return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                  f.exp_bits == 4 ? __NV_E4M3 : __NV_E5M2);
}

// code of a ratio already clipped to [-max, max], in any format (the fp8
// byte, the fp6 code or the fp4 nibble; the reference's fp8 cast,
// _encode_fp6_codes and _encode_fp4_codes): the code of r rounded to the
// nearest grid value, ties to even (formats.snap_to_fp8_grid). fp8 comes
// from fp8_pair. fp6 and fp4 are computed from r's f32 fields without
// forming the grid value: where |r| is at least the format's smallest
// normal, RNE at the format's mantissa width is an integer add on r's
// bits (a carry steps into the exponent, as rounding up to the next
// binade does) and the exponent is rebiased; below it, the code is |r| in
// steps of the smallest subnormal, rounded to even (rintf; 2^mant_bits
// there is the smallest normal's code).
__device__ __forceinline__ uint32_t encode(float r, const FmtSpec& f) {
  if (f.bits == 8) return fp8_pair(r, 0.0f, f) & 0xFFu;
  const uint32_t bits = __float_as_uint(r);
  const uint32_t mag = bits & 0x7FFFFFFFu;
  const int sh = 23 - f.mant_bits;
  const uint32_t normal =
      ((mag + (1u << (sh - 1)) - 1u + ((mag >> sh) & 1u)) >> sh) -
      (static_cast<uint32_t>(127 - f.bias) << f.mant_bits);
  const uint32_t sub = static_cast<uint32_t>(
      rintf(__uint_as_float(mag) * pow2(f.bias + f.mant_bits - 1)));
  const uint32_t code =
      __uint_as_float(mag) >= pow2(1 - f.bias) ? normal : sub;
  return code | ((bits >> 31) << (f.bits - 1));
}

// _pack_fp4: element 2i in the low nibble, 2i+1 in the high one
__device__ __forceinline__ uint8_t pack_fp4(uint32_t lo, uint32_t hi) {
  return static_cast<uint8_t>((lo | (hi << 4)) & 0xFFu);
}

// _pack_fp6: four 6-bit codes into three bytes, low bits first
__device__ __forceinline__ void pack_fp6(uint32_t c0, uint32_t c1, uint32_t c2,
                                         uint32_t c3, uint8_t* out) {
  out[0] = static_cast<uint8_t>((c0 | (c1 << 6)) & 0xFFu);
  out[1] = static_cast<uint8_t>(((c1 >> 2) | (c2 << 4)) & 0xFFu);
  out[2] = static_cast<uint8_t>(((c2 >> 4) | (c3 << 2)) & 0xFFu);
}

// _unpack_fp4 / _unpack_fp6: code of element i of a packed row
__device__ __forceinline__ uint32_t unpack_fp4(const uint8_t* row, int i) {
  return (row[i >> 1] >> ((i & 1) * 4)) & 0xFu;
}

__device__ __forceinline__ uint32_t unpack_fp6(const uint8_t* row, int i) {
  const uint8_t* b = row + 3 * (i >> 2);
  switch (i & 3) {
    case 0: return b[0] & 0x3Fu;
    case 1: return ((b[0] >> 6) | (b[1] << 2)) & 0x3Fu;
    case 2: return ((b[1] >> 4) | (b[2] << 4)) & 0x3Fu;
    default: return (b[2] >> 2) & 0x3Fu;
  }
}

// fp8 byte -> f32 value (exact), as torch's float8 -> float32 cast
__device__ __forceinline__ float fp8_value(uint8_t c, int fmt) {
  const bool neg = (c & 0x80u) != 0;
  float mag;
  if (fmt == 0) {
    const uint32_t e = (c >> 3) & 0xFu, m = c & 0x7u;
    if (e == 15u && m == 7u) {
      mag = __uint_as_float(0x7FC00000u);  // NaN
    } else if (e == 0u) {
      mag = static_cast<float>(m) * 0.001953125f;  // m * 2^-9
    } else {
      mag = pow2(static_cast<int>(e) - 7) * (1.0f + 0.125f * m);
    }
  } else {
    const uint32_t e = (c >> 2) & 0x1Fu, m = c & 0x3u;
    if (e == 31u) {
      mag = __uint_as_float(m == 0u ? 0x7F800000u : 0x7FC00000u);
    } else if (e == 0u) {
      mag = static_cast<float>(m) * 1.52587890625e-05f;  // m * 2^-16
    } else {
      mag = pow2(static_cast<int>(e) - 15) * (1.0f + 0.25f * m);
    }
  }
  return neg ? -mag : mag;
}

// four fp8 codes (one word, element 0 in the low byte) -> f32 values (exact),
// by the hardware's e4m3x2 / e5m2x2 -> f16x2 conversion (fmt 0 or 1)
__device__ __forceinline__ void fp8x4(uint32_t u, int fmt, float* v) {
  uint32_t h0, h1;
  if (fmt == 0) {
    asm("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %2;\n"
        "cvt.rn.f16x2.e4m3x2 %0, lo;\ncvt.rn.f16x2.e4m3x2 %1, hi;\n}"
        : "=r"(h0), "=r"(h1) : "r"(u));
  } else {
    asm("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %2;\n"
        "cvt.rn.f16x2.e5m2x2 %0, lo;\ncvt.rn.f16x2.e5m2x2 %1, hi;\n}"
        : "=r"(h0), "=r"(h1) : "r"(u));
  }
  const uint32_t h[2] = {h0, h1};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    __half2_raw raw;
    raw.x = static_cast<unsigned short>(h[t] & 0xFFFFu);
    raw.y = static_cast<unsigned short>(h[t] >> 16);
    const float2 fl = __half22float2(__half2(raw));
    v[2 * t] = fl.x;
    v[2 * t + 1] = fl.y;
  }
}

// _decode_fp4_codes: arithmetic E2M1 decode
__device__ __forceinline__ float decode_fp4(uint32_t c) {
  const float sign = (c & 0x8u) ? -1.0f : 1.0f;
  const int e = (c >> 1) & 0x3;
  const float m = static_cast<float>(c & 0x1u);
  const float p = static_cast<float>(1 << max(e - 1, 0));
  return sign * (e == 0 ? 0.5f * m : p * (1.0f + 0.5f * m));
}

// _decode_fp6_codes: arithmetic FP6 E3M2 / E2M3 decode
__device__ __forceinline__ float decode_fp6(uint32_t c, const FmtSpec& f) {
  const float sign = (c & 0x20u) ? -1.0f : 1.0f;
  const int e = (c >> f.mant_bits) & ((1 << f.exp_bits) - 1);
  const float m = static_cast<float>(c & ((1u << f.mant_bits) - 1u));
  const float p = static_cast<float>(1 << max(e - 1, 0)) * pow2(1 - f.bias);
  const float mag = e == 0 ? pow2(1 - f.bias - f.mant_bits) * m
                           : p * (1.0f + pow2(-f.mant_bits) * m);
  return sign * mag;
}

// value of element i of a stored row, in any format
__device__ __forceinline__ float element_value(const uint8_t* row, int i,
                                               const FmtSpec& f, int fmt) {
  if (f.bits == 8) return fp8_value(row[i], fmt);
  if (f.bits == 6) return decode_fp6(unpack_fp6(row, i), f);
  return decode_fp4(unpack_fp4(row, i));
}

// fp8 code stored as a raw byte -> f32, decoded arithmetically from its
// fields as the reference does on mixed-format pools (_decode_u8_codes):
// equal to fp8_value except on NaN/inf codes, which no encoder writes
__device__ __forceinline__ float u8_fp8_value(uint8_t c, const FmtSpec& f) {
  const int e = (c >> f.mant_bits) & ((1 << f.exp_bits) - 1);
  const float m = static_cast<float>(c & ((1u << f.mant_bits) - 1u));
  const float mag = e == 0 ? m * pow2(1 - f.bias - f.mant_bits)
                           : pow2(e - f.bias) * (1.0f + m * pow2(-f.mant_bits));
  return (c & 0x80u) ? -mag : mag;
}

// format id a mixed-pool page decodes under: its own id when it is one of
// the pool's candidate formats (bit set in `mask`), else the first
// candidate `dflt`, as the reference's select chain does
__device__ __forceinline__ int mixed_fmt(int fid, int mask, int dflt) {
  return fid >= 0 && fid < 5 && ((mask >> fid) & 1) ? fid : dflt;
}

// Quantize one MX block of n <= 32 values of a new K/V row (a page write)
// held one a lane, x already flushed (lanes >= n hold 0), into packed codes
// at `out` (n fp8 bytes, 3n/4 fp6 bytes or n/2 fp4 bytes) and one E8M0
// byte, as the reference's _quantize_rows does: the amax over the lanes (a
// max, exact in any order), each lane's code by encode(); the lane holding
// a byte's first element writes it (fp4: pairs of lanes, fp6: fours).
// Every lane of the warp calls it.
__device__ __forceinline__ void quantize_lanes(float x, uint8_t* out,
                                               uint8_t* scale, int n,
                                               const FmtSpec& f) {
  const unsigned kFull = 0xFFFFFFFFu;
  const int i = threadIdx.x & 31;
  float amax = fabsf(x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  const uint8_t e = e8m0_from_amax(amax, f);
  const float s = e8m0_to_scale(e);
  const float r = e > 0 ? x / s : 0.0f;
  const uint32_t c = i < n ? encode(fminf(fmaxf(r, -f.max), f.max), f) : 0u;
  if (f.bits == 8) {
    if (i < n) out[i] = static_cast<uint8_t>(c);
  } else if (f.bits == 4) {
    const uint32_t c1 = __shfl_down_sync(kFull, c, 1);
    if (i < n && (i & 1) == 0) out[i >> 1] = pack_fp4(c, c1);
  } else {
    const uint32_t c1 = __shfl_down_sync(kFull, c, 1);
    const uint32_t c2 = __shfl_down_sync(kFull, c, 2);
    const uint32_t c3 = __shfl_down_sync(kFull, c, 3);
    if (i < n && (i & 3) == 0) pack_fp6(c, c1, c2, c3, out + 3 * (i >> 2));
  }
  if (i == 0) *scale = e;
}

}  // namespace mx
