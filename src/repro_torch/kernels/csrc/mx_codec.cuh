// MX fp8 encode/decode device functions shared by the port's CUDA kernels.
//
// Bit-exact counterparts of repro_torch.core.formats / the reference's
// in-kernel quantizer (repro/kernels/mx_attention.py::_quantize_rows,
// repro/kernels/mx_quantize.py::_floor_log2):
//   * E8M0 shared exponent from the block amax by exponent-field floor-log2,
//     clipped to [0, 254];
//   * RNE snap of the scaled value onto the fp8 grid with rintf, then the
//     fp8 byte assembled from the (exact) grid value's fields;
//   * the reference runs with denormals flushed, so subnormal inputs and
//     products read as signed zero and E8M0 byte 0 (2^-127) acts as a zero
//     scale when quantizing. That flush is written out here: the kernels
//     are compiled without -ftz.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mx {

// fmt ids: 0 = fp8 e4m3 (float8_e4m3fn, no infinities), 1 = fp8 e5m2
struct Fp8Spec {
  int exp_bits, mant_bits, bias, emax;
  float max;
};

__device__ __forceinline__ Fp8Spec fp8_spec(int fmt) {
  return fmt == 0 ? Fp8Spec{4, 3, 7, 8, 448.0f}
                  : Fp8Spec{5, 2, 15, 15, 57344.0f};
}

constexpr float kMinNormal = 1.17549435e-38f;  // 2^-126

// subnormal -> zero of the same sign (the reference's flushed arithmetic)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kMinNormal ? copysignf(0.0f, x) : x;
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

__device__ __forceinline__ uint8_t e8m0_from_amax(float amax,
                                                  const Fp8Spec& f) {
  int e = amax > 0.0f ? floor_log2(amax) - f.emax + 127 : 0;
  return static_cast<uint8_t>(min(max(e, 0), 254));
}

// formats.snap_to_fp8_grid: exact RNE onto the fp8 grid (value space)
__device__ __forceinline__ float snap_fp8(float x, const Fp8Spec& f) {
  const float ax = fabsf(x);
  const int min_norm_exp = 2 - (1 << (f.exp_bits - 1));
  const int e = max(floor_log2(ax), min_norm_exp);
  const float q = pow2(e - f.mant_bits);
  const float y = rintf(x / q) * q;  // x / q is exact: q is a power of two
  return ax == 0.0f ? x : y;
}

// fp8 byte of a value that lies exactly on the format's grid
__device__ __forceinline__ uint8_t fp8_bits(float v, const Fp8Spec& f) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t sign = (b >> 31) << 7;
  const float a = fabsf(v);
  if (a == 0.0f) return static_cast<uint8_t>(sign);
  const int min_norm_exp = 1 - f.bias;
  const int e = floor_log2(a);
  uint32_t code;
  if (e >= min_norm_exp) {
    code = (static_cast<uint32_t>(e + f.bias) << f.mant_bits) |
           ((b & 0x7FFFFFu) >> (23 - f.mant_bits));
  } else {  // subnormal: an exact multiple of the smallest step
    code = static_cast<uint32_t>(a / pow2(min_norm_exp - f.mant_bits));
  }
  return static_cast<uint8_t>(sign | code);
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

// Quantize one MX block of n bf16 values into n fp8 bytes and one E8M0
// byte, as _quantize_rows does. -0.0 inputs are read as +0.0: the
// reference gathers the new rows through an exact one-hot f32 matmul,
// whose +0-initialised sum turns -0.0 into +0.0.
__device__ __forceinline__ void quantize_block(const __nv_bfloat16* src,
                                               uint8_t* elems, uint8_t* scale,
                                               int n, const Fp8Spec& f) {
  float amax = 0.0f;
  for (int i = 0; i < n; ++i) {
    amax = fmaxf(amax, fabsf(flush(__bfloat162float(src[i]))));
  }
  const uint8_t e = e8m0_from_amax(amax, f);
  const float s = e8m0_to_scale(e);
  for (int i = 0; i < n; ++i) {
    float x = flush(__bfloat162float(src[i]));
    x = x == 0.0f ? 0.0f : x;
    float r = e > 0 ? x / s : 0.0f;
    r = fminf(fmaxf(r, -f.max), f.max);
    elems[i] = fp8_bits(snap_fp8(r, f), f);
  }
  *scale = e;
}

}  // namespace mx
