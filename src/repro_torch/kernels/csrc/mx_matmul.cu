// MX matrix products, the paper's VMXDOTP analogue: three kernels.
//
// Replace the TPU kernels of repro/kernels/mx_matmul.py:
//   * mx_matmul_wo    (_mx_matmul_wo_kernel): out (M, N) = A (M, K) wide
//     (bf16 or f32) x dequant(B)^T, B stored (N, K) blocked along K;
//   * mx_matmul_vv    (_mx_matmul_kernel): both operands MX (paper Eq. 2),
//     A stored (M, K) and B (N, K), same format and block size;
//   * mx_matmul_dgrad (_mx_dgrad_kernel): dx (M, K) = dy (M, N) f32 x
//     dequant(W), reading W's stored (N, K) layout as it is.
// Operands are fp8 e4m3 / e5m2 bytes or fp4 e2m1 nibbles (two per byte, low
// first) with one E8M0 byte per block; any block size dividing K.
//
// Arithmetic, as the reference's: each element is decoded to f32 and its
// block's power-of-two scale folded in (exact; flushed to zero below the
// normal range, as the reference's flushed arithmetic reads it), and the
// contraction runs in `tile`-wide pieces in ascending order. Each piece's
// f32 partial sum is added to the output: in f32, or, with bf16
// accumulation, rounded to bf16 and added to the bf16 output with one more
// rounding (o += partial.astype(bf16)), so the wrapper passes the
// reference's K-tile width and the kernel rounds where it does.
//
// Design. One CTA of 256 threads owns a 64 x 64 output tile and loops over
// the whole contraction itself (no split-K: the bf16 rounding points are
// per tile and in order). Per 32-wide contraction chunk it stages the
// compact operand bytes (codes and E8M0 bytes) in shared memory, decodes
// them in registers with the mx_codec.cuh decoders, folds the scales and
// writes the f32 tile to shared memory, where every thread takes 4 x 4
// outputs with f32 FMAs. Ragged M, N and K edges are masked.
//
// What bounds it on an H100 SXM (data-sheet peaks). At granite-8b's gate
// projection (K 4096, N 14336) in fp8, M = 512 rows do 60 GFLOP against
// 94 MB of traffic: bound by operations (61 us at the bf16 tensor-core rate
// of 989 TFLOP/s); a decode step's M = 8 rows move 61 MB (58.7 MB of them
// weight codes) for 0.9 GFLOP: bound by bytes (18 us at 3.35 TB/s). This
// first version reads the compact bytes once per CTA row of tiles and keeps
// every wide value out of device memory, which is what the bytes-bound
// case needs; it uses scalar f32 FMAs (67 TFLOP/s peak) instead of
// wgmma, so the operations-bound case runs far from its bound. Decoding to
// bf16 (exact for MX values) and wgmma, or one fp8 MMA per MX block with
// scaled f32 partials, are the levers for a later change; chip_smoke.py
// times each kernel against its bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 32;     // contraction elements staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTile + 1; // padded row of a decoded f32 tile

enum Kind { kWo = 0, kVv = 1, kDgrad = 2 };

struct Args {
  const void* a;           // wo: (M, K) wide; vv: (M, ek) codes; dgrad: dy
  const uint8_t* a_scales; // vv: (M, K / block)
  const uint8_t* b;        // (N, ek) codes, W stored (N, K) blocked along K
  const uint8_t* b_scales; // (N, K / block)
  void* out;               // wo / vv: (M, N); dgrad: (M, K) f32
  int M, N, K;
  int ek;                  // bytes of one stored row: K (fp8) or K / 2
  int tile;                // contraction piece of one partial sum
  int block, fmt, out_bf16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A wide tile: rows [r0, r0 + rows) x columns [c0, c0 + cols) of a
// row-major (., ld) array into dst[c * kLd + r] (f32, flushed), zero-padded
// to kTile rows x kChunk columns.
template <typename T>
__device__ __forceinline__ void load_wide(const T* __restrict__ a, int ld,
                                          int r0, int rows, int c0, int cols,
                                          float* dst) {
  for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    float v = 0.0f;
    if (r < rows && c < cols) {
      v = mx::flush(to_f32(a[static_cast<size_t>(r0 + r) * ld + c0 + c]));
    }
    dst[c * kLd + r] = v;
  }
}

// An MX tile: rows [r0, r0 + rows) x elements [e0, e0 + elems) of an
// operand stored (., K) blocked along K. Its code and E8M0 bytes are staged
// in q / s (R x W bytes each), then decoded with the scale folded in:
// dst[c * kLd + r] when kTransposed, else dst[r * kLd + c]. e0 is even for
// fp4, so a row's nibbles start on a byte.
template <int R, int W, bool kTransposed>
__device__ __forceinline__ void load_mx(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ scales,
    int ek, int nblocks, int r0, int rows, int e0, int elems, int block,
    int fmt, const mx::FmtSpec& f, uint8_t* q, uint8_t* s, float* dst) {
  rows = min(rows, R);
  elems = min(elems, W);
  const int row_bytes = f.bits == 4 ? elems / 2 : elems;
  const int byte0 = f.bits == 4 ? e0 / 2 : e0;
  const int kb0 = e0 / block;
  const int nsb = elems > 0 ? (e0 + elems - 1) / block - kb0 + 1 : 0;
  for (int i = threadIdx.x; i < R * W; i += kThreads) {
    const int r = i / W, c = i % W;
    const size_t row = static_cast<size_t>(r0 + r);
    q[i] = r < rows && c < row_bytes ? codes[row * ek + byte0 + c] : 0;
    s[i] = r < rows && c < nsb ? scales[row * nblocks + kb0 + c] : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * W; i += kThreads) {
    const int r = i / W, c = i % W;
    float v = 0.0f;
    if (r < rows && c < elems) {
      const float x = mx::element_value(q + r * W, c, f, fmt);
      v = mx::flush(x * mx::e8m0_factor(s[r * W + (e0 + c) / block - kb0]));
    }
    dst[kTransposed ? c * kLd + r : r * kLd + c] = v;
  }
}

template <int KIND, typename AT>
__global__ void __launch_bounds__(kThreads) mx_matmul_kernel(Args p) {
  __shared__ uint8_t qa[kTile * kChunk], sa[kTile * kChunk];
  __shared__ uint8_t qb[kTile * kChunk], sb[kTile * kChunk];
  __shared__ float As[kChunk * kLd], Bs[kChunk * kLd];
  const mx::FmtSpec f = mx::fmt_spec(p.fmt);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int out_cols = KIND == kDgrad ? p.K : p.N;
  const int depth = KIND == kDgrad ? p.N : p.K;  // contraction length
  const int nblocks = p.K / p.block;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t0 = 0; t0 < depth; t0 += p.tile) {
    const int t1 = min(t0 + p.tile, depth);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    for (int c0 = t0; c0 < t1; c0 += kChunk) {
      const int len = min(kChunk, t1 - c0);
      if constexpr (KIND == kWo) {
        load_wide(static_cast<const AT*>(p.a), p.K, m0, p.M - m0, c0, len,
                  As);
        load_mx<kTile, kChunk, true>(p.b, p.b_scales, p.ek, nblocks, j0,
                                     p.N - j0, c0, len, p.block, p.fmt, f,
                                     qb, sb, Bs);
      } else if constexpr (KIND == kVv) {
        load_mx<kTile, kChunk, true>(static_cast<const uint8_t*>(p.a),
                                     p.a_scales, p.ek, nblocks, m0, p.M - m0,
                                     c0, len, p.block, p.fmt, f, qa, sa, As);
        load_mx<kTile, kChunk, true>(p.b, p.b_scales, p.ek, nblocks, j0,
                                     p.N - j0, c0, len, p.block, p.fmt, f,
                                     qb, sb, Bs);
      } else {
        load_wide(static_cast<const float*>(p.a), p.N, m0, p.M - m0, c0, len,
                  As);
        load_mx<kChunk, kTile, false>(p.b, p.b_scales, p.ek, nblocks, c0,
                                      len, j0, p.K - j0, p.block, p.fmt, f,
                                      qb, sb, Bs);
      }
      __syncthreads();
      for (int kk = 0; kk < len; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = p.out_bf16 ? round_bf16(acc[i][j] + round_bf16(part[i][j]))
                               : acc[i][j] + part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= out_cols) continue;
      const size_t o = static_cast<size_t>(m) * out_cols + col;
      if (p.out_bf16) {
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(acc[i][j]);
      } else {
        static_cast<float*>(p.out)[o] = acc[i][j];
      }
    }
  }
}

dim3 grid_for(int rows, int cols) {
  return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
}

}  // namespace

// Each launcher returns cudaGetLastError() after the launch. Sizes are
// logical: K elements per stored row, ek = storage_len(K) bytes.

extern "C" int mx_matmul_wo_launch(const void* a, int a_bf16, const void* b,
                                   const void* b_scales, void* out, int M,
                                   int N, int K, int ek, int tile, int block,
                                   int fmt, int out_bf16, void* stream) {
  const Args p{a, nullptr, static_cast<const uint8_t*>(b),
               static_cast<const uint8_t*>(b_scales), out, M, N, K, ek, tile,
               block, fmt, out_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16) {
    mx_matmul_kernel<kWo, __nv_bfloat16>
        <<<grid_for(M, N), kThreads, 0, s>>>(p);
  } else {
    mx_matmul_kernel<kWo, float><<<grid_for(M, N), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_matmul_vv_launch(const void* a, const void* a_scales,
                                   const void* b, const void* b_scales,
                                   void* out, int M, int N, int K, int ek,
                                   int tile, int block, int fmt, int out_bf16,
                                   void* stream) {
  const Args p{a, static_cast<const uint8_t*>(a_scales),
               static_cast<const uint8_t*>(b),
               static_cast<const uint8_t*>(b_scales), out, M, N, K, ek, tile,
               block, fmt, out_bf16};
  mx_matmul_kernel<kVv, uint8_t>
      <<<grid_for(M, N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_matmul_dgrad_launch(const void* dy, const void* b,
                                      const void* b_scales, void* dx, int M,
                                      int N, int K, int ek, int tile,
                                      int block, int fmt, void* stream) {
  const Args p{dy, nullptr, static_cast<const uint8_t*>(b),
               static_cast<const uint8_t*>(b_scales), dx, M, N, K, ek, tile,
               block, fmt, 0};
  mx_matmul_kernel<kDgrad, float>
      <<<grid_for(M, K), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
