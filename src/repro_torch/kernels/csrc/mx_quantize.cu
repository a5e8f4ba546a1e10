// Fused MX block quantization: wide rows -> packed element codes + E8M0.
//
// Replaces the TPU kernel repro/kernels/mx_quantize.py::mx_quantize (body
// _mx_quantize_kernel, one pallas_call over (M/bm, K/bk) tiles). For every
// block of `block` elements along a row of x (M, K), f32 or bf16:
//   amax -> E8M0 byte by exponent-field floor-log2 (clipped to [0, 254]) ->
//   ratio = (e > 0) ? x / 2^(e-127) : 0, clipped to the format's range ->
//   RNE code (fp8 byte, fp6 code or fp4 nibble), packed as the reference
//   packs it (fp4: two per byte, low nibble first; fp6: four per three
//   bytes, low bits first).
// The codes come from mx_codec.cuh's encoder, which every writing kernel
// of the port calls: fp8 bytes two at a time from fp8_pair (the hardware's
// RNE conversion, its saturation the reference's clip), fp6 and fp4 codes
// from encode(). Subnormal inputs read
// as signed zero, as the reference's arithmetic reads them (no -ftz here:
// see mx_codec.cuh): the amax of the raw values gives the same E8M0 byte,
// and the ratio x * 2^(127-e) is one flushing multiply by the exact
// reciprocal, whose bits are those of the reference's divide by
// 2^(e-127) (e8m0_recip, mul_ftz).
//
// Design. A lane owns four consecutive elements of a row: one 16-byte f32
// load or one 8-byte bf16 load. Blocks that divide 128 (1 to 128) take a
// group of 128 elements a warp: a block of 1, 2 or 4 reduces in the lane,
// a larger one in the lane and then across block/4 lanes with
// log2(block/4) xor shuffles. A warp owns a run of up to kMaxRun groups
// of one or more rows and issues all of their loads before its first
// reduction. Each lane packs its four codes itself and stores them at
// once: one 32-bit word (fp8), 3 bytes (fp6) or 16 bits (fp4); the
// block's first lane writes the scale. Other multiples of 32 (96, 160,
// 256, ...) take one block a warp group, its amax across the warp, then a
// second pass over the block's elements to encode them. Where K % 4 != 0
// or x's rows are not aligned for the vector loads, the same mapping
// loads and stores element by element (the scalar tail: fp8 at any K,
// fp4 at K % 4 == 2). The kernel is templated on the element format.
//
// The host sizes the run so that the grid holds about 32 warps an SM, and
// gives small grids 2-warp CTAs so that M = 8 still spreads over the SMs
// (run length and grid as tools/profile_mx_writers.py --sweep chose them;
// PERF.md).
//
// What bounds it on an H100 SXM (data-sheet peaks): it reads x once and
// writes codes and scales once, ~50 instructions a 4-element lane-quad,
// so it is bound by bytes: at (512, 4096) f32 -> fp8, 8.4 MB in, 2.2 MB
// out, 3.1 us at 3.35 TB/s; at M = 8 a DRAM round trip and the launch set
// the time. chip_smoke.py times it against that bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>

#include "mx_codec.cuh"

namespace {

constexpr int kMaxRun = 2;  // groups a warp loads before it reduces
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Params {
  uint8_t* elems;   // (M, ek)
  uint8_t* scales;  // (M, K / block)
  int K, ek, block, fmt;
  int nb;           // scales a row, K / block
  int lb;           // log2(block) when blocks divide 128
  int gpr;          // groups a row: 128-element groups, or blocks
  long long total;  // M * gpr
  int run;          // groups a warp
  int wide;         // blocks divide 128 (else one block a group)
};

// elements col..col+3 of a row (those at or past K read as 0)
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int col, int K,
                                      float* v) {
  if constexpr (kVec) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col < K) t = *reinterpret_cast<const float4*>(row + col);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < K ? row[col + i] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int col,
                                      int K, float* v) {
  if constexpr (kVec) {
    uint2 t = make_uint2(0, 0);
    if (col < K) t = *reinterpret_cast<const uint2*>(row + col);
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xFFFF0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = col + i < K ? __bfloat162float(row[col + i]) : 0.0f;
    }
  }
}

// fp8 bytes of four ratios; satfinite clips to the format's range, as
// the reference clips before its cast
template <int FMT>
__device__ __forceinline__ uint32_t fp8_word(const float* r) {
  constexpr mx::FmtSpec f = mx::fmt_spec(FMT);
  return mx::fp8_pair(r[0], r[1], f) | (mx::fp8_pair(r[2], r[3], f) << 16);
}

// the ratio of x to its block's scale, x * 2^(127-e) (0 at E8M0 byte
// 0): the product flushes a subnormal x to signed zero, as the reference
// flushes its input (its subnormal results encode as the same signed zero)
__device__ __forceinline__ float ratio(float x, uint8_t e) {
  return e > 0 ? mx::mul_ftz(x, mx::e8m0_recip(e)) : 0.0f;
}

// encode the ratios r of elements col..col+3 of a row and store their
// codes (those at or past K are not stored)
template <int FMT, bool kVec>
__device__ __forceinline__ void encode_store(const Params& p, int row,
                                             int col, float* r) {
  constexpr mx::FmtSpec f = mx::fmt_spec(FMT);
  uint8_t* er = p.elems + static_cast<size_t>(row) * p.ek;
  if constexpr (f.bits == 8) {
    const uint32_t w = fp8_word<FMT>(r);
    if constexpr (kVec) {
      *reinterpret_cast<uint32_t*>(er + col) = w;
    } else {
      for (int t = 0; t < 4 && col + t < p.K; ++t) {
        er[col + t] = w >> (8 * t);
      }
    }
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      w |= mx::encode(fminf(fmaxf(r[t], -f.max), f.max), f) << (t * f.bits);
    }
    if constexpr (f.bits == 6) {  // K % 4 == 0: whole quads
      uint8_t* o = er + 3 * (col >> 2);
      o[0] = w, o[1] = w >> 8, o[2] = w >> 16;
    } else if constexpr (kVec) {
      *reinterpret_cast<uint16_t*>(er + (col >> 1)) = w;
    } else {  // K % 2 == 0: whole pairs
      for (int t = 0; t < 4 && col + t < p.K; t += 2) {
        er[(col + t) >> 1] = w >> (4 * t);
      }
    }
  }
}

template <typename T, int FMT, bool kVec>
__global__ void __launch_bounds__(256)
    mx_quantize_kernel(const T* __restrict__ x, const Params p) {
  constexpr mx::FmtSpec f = mx::fmt_spec(FMT);
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  const long long g0 = warp * p.run;
  if (g0 >= p.total) return;  // warp-wide

  // the run's first group, then the next one a step at a time
  const bool narrow = p.total <= 0x7FFFFFFF;  // 32-bit divides suffice
  const int row0 = narrow ? static_cast<int>(g0) / p.gpr
                          : static_cast<int>(g0 / p.gpr);
  const int grp0 = static_cast<int>(g0 - static_cast<long long>(row0) *
                                             p.gpr);
  const int n = p.total - g0 < p.run ? static_cast<int>(p.total - g0) : p.run;

  if (!p.wide) {  // one block a group: amax across the warp, then encode
    for (int r = 0, row = row0, grp = grp0; r < n; ++r) {
      const int c0 = grp * p.block;
      const T* xr = x + static_cast<size_t>(row) * p.K;
      float amax = 0.0f;
      for (int c = 4 * lane; c < p.block; c += 128) {
        float v[4];
        load4<kVec>(xr, c0 + c, p.K, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) amax = fmaxf(amax, fabsf(v[t]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
      }
      const uint8_t e = mx::e8m0_from_amax(amax, f);
      for (int c = 4 * lane; c < p.block; c += 128) {
        float v[4];
        load4<kVec>(xr, c0 + c, p.K, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = ratio(v[t], e);
        encode_store<FMT, kVec>(p, row, c0 + c, v);
      }
      if (lane == 0) p.scales[static_cast<size_t>(row) * p.nb + grp] = e;
      if (++grp == p.gpr) grp = 0, ++row;
    }
    return;
  }

  // every load of the run first
  float v[kMaxRun][4];
#pragma unroll
  for (int r = 0, row = row0, grp = grp0; r < kMaxRun; ++r) {
    if (r < n) {
      load4<kVec>(x + static_cast<size_t>(row) * p.K, grp * 128 + 4 * lane,
                  p.K, v[r]);
    }
    if (++grp == p.gpr) grp = 0, ++row;
  }
  const int mask = p.block - 1;  // blocks divide 128: powers of two
#pragma unroll
  for (int r = 0, row = row0, grp = grp0; r < kMaxRun; ++r) {
    if (r >= n) break;  // warp-uniform
    const int col = grp * 128 + 4 * lane;
    // the amax of the raw values: a subnormal amax gives E8M0 byte 0 as
    // the flushed block's zero amax does, a normal one is unchanged
    float a[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) a[t] = fabsf(v[r][t]);
    uint8_t* sr = p.scales + static_cast<size_t>(row) * p.nb;
    if (p.block >= 4) {  // one block over the lane's four elements
      float amax = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (4 * off < p.block) {  // warp-uniform
          amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
        }
      }
      const uint8_t e = mx::e8m0_from_amax(amax, f);
      if (col < p.K) {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[r][t] = ratio(v[r][t], e);
        encode_store<FMT, kVec>(p, row, col, v[r]);
        if ((col & mask) == 0) sr[col >> p.lb] = e;
      }
    } else {  // blocks of 1 or 2
      if (p.block == 2) {
        a[0] = a[1] = fmaxf(a[0], a[1]);
        a[2] = a[3] = fmaxf(a[2], a[3]);
      }
      uint8_t e[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        e[t] = mx::e8m0_from_amax(a[t], f);
        v[r][t] = ratio(v[r][t], e[t]);
      }
      if (col < p.K) {
        encode_store<FMT, kVec>(p, row, col, v[r]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if ((t & mask) == 0 && col + t < p.K) sr[(col + t) >> p.lb] = e[t];
        }
      }
    }
    if (++grp == p.gpr) grp = 0, ++row;
  }
}

int g_sms = 0;  // the card's SM count, read at the first launch

template <typename T, int FMT>
void launch(const T* x, const Params& p, bool vec, unsigned grid,
            int threads, cudaStream_t s) {
  if (vec) {
    mx_quantize_kernel<T, FMT, true><<<grid, threads, 0, s>>>(x, p);
  } else {
    mx_quantize_kernel<T, FMT, false><<<grid, threads, 0, s>>>(x, p);
  }
}

template <typename T>
void launch(const T* x, const Params& p, bool vec, unsigned grid,
            int threads, cudaStream_t s) {
  switch (p.fmt) {
    case 0: launch<T, 0>(x, p, vec, grid, threads, s); break;
    case 1: launch<T, 1>(x, p, vec, grid, threads, s); break;
    case 2: launch<T, 2>(x, p, vec, grid, threads, s); break;
    case 3: launch<T, 3>(x, p, vec, grid, threads, s); break;
    default: launch<T, 4>(x, p, vec, grid, threads, s); break;
  }
}

}  // namespace

// x: (M, K) f32 (x_bf16 == 0) or bf16; elems: (M, ek) bytes with
// ek = storage_len(K); scales: (M, K / block). block must divide K and
// either divide 32 or be a multiple of 32. Returns cudaGetLastError().
extern "C" int mx_quantize_launch(const void* x, int x_bf16, void* elems,
                                  void* scales, int M, int K, int ek,
                                  int block, int fmt, void* stream) {
  if (M < 1 || K < 1 || block < 1 || K % block != 0 || fmt < 0 || fmt > 4 ||
      !(block <= 32 ? 32 % block == 0 : block % 32 == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms < 1) g_sms = 1;
  }
  Params p;
  p.elems = static_cast<uint8_t*>(elems);
  p.scales = static_cast<uint8_t*>(scales);
  p.K = K, p.ek = ek, p.block = block, p.fmt = fmt;
  p.nb = K / block;
  p.lb = 0;
  while ((1 << p.lb) < block) ++p.lb;
  p.wide = 128 % block == 0;
  p.gpr = p.wide ? (K + 127) / 128 : K / block;
  p.total = static_cast<long long>(M) * p.gpr;
  const long long target = 32LL * g_sms;  // warps the grid aims at
  p.run = static_cast<int>(
      std::min<long long>(kMaxRun, std::max<long long>(
                                       1, (p.total + target - 1) / target)));
  const long long warps = (p.total + p.run - 1) / p.run;
  const int per_cta = warps >= 16LL * g_sms ? 8 : 2;
  const unsigned grid =
      static_cast<unsigned>((warps + per_cta - 1) / per_cta);
  const uintptr_t align = x_bf16 ? 8 : 16;
  const bool vec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % align == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    launch(static_cast<const __nv_bfloat16*>(x), p, vec, grid, 32 * per_cta,
           s);
  } else {
    launch(static_cast<const float*>(x), p, vec, grid, 32 * per_cta, s);
  }
  return static_cast<int>(cudaGetLastError());
}
