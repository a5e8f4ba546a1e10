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
// The encoders are the mx_codec.cuh device functions that the ragged page
// write also calls, so every writing kernel of the port stores the same
// bytes for the same values. Subnormal inputs are flushed to signed zero,
// as the reference's arithmetic does (no -ftz here: see mx_codec.cuh).
//
// Design. A warp owns a run of consecutive 32-element steps of one row,
// one element per lane, so every load is one coalesced 128-byte (f32) or
// 64-byte (bf16) transaction. Block sizes that divide 32 reduce the amax
// with xor shuffles inside groups of `block` lanes; block sizes that are
// multiples of 32 give a lane block/32 elements of one block per step and
// reduce across the whole warp. Packing moves neighbouring lanes' codes
// with shuffles: an even lane writes an fp4 byte, every fourth lane the
// three fp6 bytes, so packing needs only K % 2 (fp4) or K % 4 (fp6).
//
// What bounds it on an H100 SXM (data-sheet peaks): it reads x once and
// writes codes and scales once, a handful of f32 operations per element,
// so it is bound by bytes: at (512, 14336) f32 -> fp8, 29.4 MB in, 7.6 MB
// out, ~11 us at 3.35 TB/s. The design's only aim on that front is full
// coalescing of the one read and the writes; chip_smoke.py times it
// against that bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kWarps = 8;          // warps per CTA
constexpr int kStepsPerWarp = 8;   // consecutive steps one warp handles
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float load(const float* x, size_t i) {
  return x[i];
}

__device__ __forceinline__ float load(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    mx_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ elems,
                       uint8_t* __restrict__ scales, int M, int K, int ek,
                       int block, int fmt, int runs_per_row) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(M) * runs_per_row) return;  // warp-wide
  const int row = static_cast<int>(warp / runs_per_row);
  const int run = static_cast<int>(warp % runs_per_row);
  const mx::FmtSpec f = mx::fmt_spec(fmt);
  const int lanes = min(block, 32);           // lanes sharing one block
  const int per_lane = max(block / 32, 1);    // elements of a block per lane
  const int step = 32 * per_lane;
  const int steps = (K + step - 1) / step;
  const T* xr = x + static_cast<size_t>(row) * K;
  uint8_t* er = elems + static_cast<size_t>(row) * ek;
  uint8_t* sr = scales + static_cast<size_t>(row) * (K / block);
  const int s_end = min(steps, (run + 1) * kStepsPerWarp);
  for (int s = run * kStepsPerWarp; s < s_end; ++s) {
    const int base = s * step;
    float amax = 0.0f;
    for (int v = 0; v < per_lane; ++v) {
      const int k = base + v * 32 + lane;
      if (k < K) amax = fmaxf(amax, fabsf(mx::flush(load(xr, k))));
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    }
    const uint8_t e = mx::e8m0_from_amax(amax, f);
    const float scale = mx::e8m0_to_scale(e);
    for (int v = 0; v < per_lane; ++v) {
      const int k = base + v * 32 + lane;
      const bool live = k < K;
      // E8M0 byte 0 (2^-127) reads as a zero scale in the reference's
      // flushed arithmetic: the whole block encodes +0
      float r = live && e > 0 ? mx::flush(load(xr, k)) / scale : 0.0f;
      r = fminf(fmaxf(r, -f.max), f.max);
      const uint32_t code = mx::encode(r, f);
      if (f.bits == 8) {
        if (live) er[k] = static_cast<uint8_t>(code);
      } else if (f.bits == 4) {
        const uint32_t hi = __shfl_down_sync(kFull, code, 1);
        if (live && (lane & 1) == 0) er[k >> 1] = mx::pack_fp4(code, hi);
      } else {
        const uint32_t c1 = __shfl_down_sync(kFull, code, 1);
        const uint32_t c2 = __shfl_down_sync(kFull, code, 2);
        const uint32_t c3 = __shfl_down_sync(kFull, code, 3);
        if (live && (lane & 3) == 0) {
          mx::pack_fp6(code, c1, c2, c3, er + 3 * (k >> 2));
        }
      }
      if (live && k % block == 0) sr[k / block] = e;
    }
  }
}

}  // namespace

// x: (M, K) f32 (x_bf16 == 0) or bf16; elems: (M, ek) bytes with
// ek = storage_len(K); scales: (M, K / block). block must divide K and
// either divide 32 or be a multiple of 32. Returns cudaGetLastError().
extern "C" int mx_quantize_launch(const void* x, int x_bf16, void* elems,
                                  void* scales, int M, int K, int ek,
                                  int block, int fmt, void* stream) {
  const int step = 32 * (block > 32 ? block / 32 : 1);
  const int steps = (K + step - 1) / step;
  const int runs = (steps + kStepsPerWarp - 1) / kStepsPerWarp;
  const long long warps = static_cast<long long>(M) * runs;
  const unsigned grid = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* e = static_cast<uint8_t*>(elems);
  uint8_t* sc = static_cast<uint8_t*>(scales);
  if (x_bf16) {
    mx_quantize_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), e, sc, M, K, ek, block, fmt,
        runs);
  } else {
    mx_quantize_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), e, sc, M, K, ek, block, fmt, runs);
  }
  return static_cast<int>(cudaGetLastError());
}
