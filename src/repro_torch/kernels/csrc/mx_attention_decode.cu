// The reference's two-pass paged decode: the page-table gather of compact
// MX pools into contiguous caches, and full-T decode attention over a
// contiguous compact MX cache.
//
// Replace the TPU kernels of repro/kernels/mx_attention.py:
//   * gather_kv_pages (body _gather_pages_kernel, one pallas_call over the
//     grid (B, KVH, P) whose index maps read the scalar-prefetched page
//     table): block (b, h, p) copies pool page clip(table[b, p], 0, NP - 1),
//     rows [:, h, :], into rows [p * PS, (p + 1) * PS) of out[b, h] -- the
//     element bytes (ED = D for fp8, 3D/4 for packed fp6, D/2 for packed
//     fp4) and the NB E8M0 bytes, of K and of V. A -1 entry reads page 0,
//     as in the reference; its rows are masked by the decode's kpos.
//   * mx_attention_decode (body _mx_attn_kernel, one pallas_call over the
//     grid (B, KVH)): for the G query rows of one (b, kv-head) cell, the
//     logits against all T keys in f32, times d^-0.5, with the optional
//     tanh softcap; the mask (kpos <= pos) & (kpos >= 0) sets the finite
//     NEG_INF = -2e38; then one max over all T, exp(l - m), the sum, and
//     out = (p @ V) / denom, divided after the product. This is not an
//     online softmax: a row whose every key is masked gets exp(0) = 1 for
//     each key, the mean of V over T, as in the reference.
//
// Design. The gather is a byte copy: one CTA per (p, kv-head, b) tile with
// the widest vector load (16 down to 1 bytes) that the row width and both
// base addresses allow, chosen per array on the host. The decode splits
// each cell's T keys over S CTAs of 64 keys (mx_attention.decode_plan, a
// function of T alone; of 16-64 keys, 64 ran fastest at granite's shapes),
// then combines:
//   * decode_split_kernel, grid (S, B * KVH): K and V rows of the split's
//     keys arrive by 16-byte loads (fp8 and fp4 rows; element by element
//     otherwise), decoded (fp8 pairs by the hardware's cvt, E8M0 factor,
//     flush of subnormal products, as every decode in the port) into
//     shared tiles; each thread forms (query row, key) logits as four f32
//     FMA chains over D (16-byte reads, conflict-free); one warp per query
//     row takes the split's max m_s, p = exp(l - m_s) and l_s; each thread
//     owns 4 consecutive (row, d) outputs of o_s = p @ V over the split's
//     keys in order;
//     (m_s, l_s, o_s) go to a workspace.
//   * decode_combine_kernel, one CTA per (cell, query row): M = max m_s,
//     the factors exp(m_s - M) once, then in ascending split order the
//     sums of l_s exp(m_s - M) and o_s exp(m_s - M), and out = their
//     quotient. No atomics: two calls give the same bits, and the paged and
//     contiguous calls (same shapes) the same plan.
//   The reference's semantics survive the split: a wholly masked row has
//   every m_s = NEG_INF and every factor 1, so it returns the mean of V; a
//   wholly masked split of a live row gets the factor exp(NEG_INF - M) = 0.
//
// What bounds them on an H100 SXM (data-sheet peaks). Both move bytes and
// do little arithmetic: at granite-8b shapes (B 8, KVH 8, D 128, 21 pages
// of 16 rows, fp8) the gather reads and writes ~5.7 MB each way and the
// decode moves ~5.9 MB, a few microseconds at 3.35 TB/s; the decode's
// 2 * G * T * D multiply-adds per cell are a few MFLOP. With 64 cells a
// CTA per cell left half the card idle; the split puts every SM to work
// on a short chain of loads, decode and two small reductions, and the
// combine adds one launch. chip_smoke.py times both beside their bounds
// (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kGatherThreads = 128;
constexpr int kThreads = 256;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF

// ---------------------------------------------------------------------------
// gather_kv_pages
// ---------------------------------------------------------------------------

struct GatherArgs {
  const uint8_t* src[4];  // ke, ks, ve, vs pools: (NP, PS, KVH, width)
  uint8_t* dst[4];        // (B, KVH, P * PS, width)
  int width[4];           // ED, NB, ED, NB bytes
  int vec[4];             // bytes per load of each array
  const int* table;       // (B, P)
  int P, NP, PS, KVH;
};

template <class V>
__device__ __forceinline__ void copy_rows(const uint8_t* src, uint8_t* dst,
                                          int width, size_t page, int h,
                                          size_t out_row0, int PS, int KVH) {
  const int nv = width / static_cast<int>(sizeof(V));
  for (int i = threadIdx.x; i < PS * nv; i += blockDim.x) {
    const int j = i / nv, c = i % nv;
    const V* s = reinterpret_cast<const V*>(
        src + ((page * PS + j) * KVH + h) * static_cast<size_t>(width));
    V* d = reinterpret_cast<V*>(dst + (out_row0 + j) * width);
    d[c] = s[c];
  }
}

__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const GatherArgs a) {
  const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int entry = a.table[static_cast<size_t>(b) * a.P + p];
  const size_t page = static_cast<size_t>(min(max(entry, 0), a.NP - 1));
  const size_t out_row0 =
      (static_cast<size_t>(b) * a.KVH + h) * a.P * a.PS +
      static_cast<size_t>(p) * a.PS;
  for (int k = 0; k < 4; ++k) {
    switch (a.vec[k]) {
      case 16:
        copy_rows<uint4>(a.src[k], a.dst[k], a.width[k], page, h, out_row0,
                         a.PS, a.KVH);
        break;
      case 8:
        copy_rows<uint2>(a.src[k], a.dst[k], a.width[k], page, h, out_row0,
                         a.PS, a.KVH);
        break;
      case 4:
        copy_rows<uint32_t>(a.src[k], a.dst[k], a.width[k], page, h,
                            out_row0, a.PS, a.KVH);
        break;
      case 2:
        copy_rows<uint16_t>(a.src[k], a.dst[k], a.width[k], page, h,
                            out_row0, a.PS, a.KVH);
        break;
      default:
        copy_rows<uint8_t>(a.src[k], a.dst[k], a.width[k], page, h,
                           out_row0, a.PS, a.KVH);
    }
  }
}

// the widest load in {16, 8, 4, 2, 1} bytes dividing the row width that
// both arrays' base addresses are aligned to
int vec_bytes(const void* s, const void* d, int width) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(d);
  int v = 16;
  while (v > 1 && (width % v != 0 || addr % v != 0)) v >>= 1;
  return v;
}

// ---------------------------------------------------------------------------
// mx_attention_decode
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;        // (B, KVH, G, D) bf16 or f32
  const uint8_t* ke;    // (B, KVH, T, ED)
  const uint8_t* ks;    // (B, KVH, T, NB)
  const uint8_t* ve;
  const uint8_t* vs;
  const int* kpos;      // (B, T)
  const int* pos;       // (B,)
  float* out;           // (B, KVH, G, D)
  float* ws_o;          // (B * KVH, S, G, D): each split's unnormalised P.V
  float* ws_ml;         // (B * KVH, S, G, 2): each split's max and sum
  int KVH, G, D, T, ED, NB, BS, fmt;
  int splits, chunk;    // S splits of `chunk` keys (the last may be short)
  int fast;             // 16-byte loads (mx_attention_decode_launch)
  float softcap, scale;
};

// a decoded tile row: D rounded up to 4 (zeros beyond D) plus 4, so that
// 16-byte reads of consecutive rows fall in distinct banks
__host__ __device__ inline int tile_pitch(int D) { return (D + 3) / 4 * 4 + 4; }

__host__ __device__ inline size_t decode_smem_bytes(int G, int D, int chunk) {
  return (static_cast<size_t>(G) * tile_pitch(D) +
          2 * static_cast<size_t>(chunk) * tile_pitch(D) +
          static_cast<size_t>(G) * chunk) *
         sizeof(float);
}

__device__ __forceinline__ float load_q(const __nv_bfloat16* q, size_t i) {
  return __bfloat162float(q[i]);
}
__device__ __forceinline__ float load_q(const float* q, size_t i) {
  return q[i];
}

// Keys [t0, t0 + n) of the cell's K and V rows, decoded (E8M0 factor
// folded in, subnormal products flushed) into the (n, pitch) tiles, element
// by element: any format, width and block.
__device__ inline void load_kv_rows(const DecodeArgs& a, size_t row0, int n,
                                    float* kt, float* vt) {
  const mx::FmtSpec f = mx::fmt_spec(a.fmt);
  const int pitch = tile_pitch(a.D), w = pitch - 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
    const int j = i / w, d = i % w;
    const size_t r = row0 + j;
    float kv = 0.0f, vv = 0.0f;
    if (d < a.D) {
      const uint8_t sk = a.ks[r * a.NB + d / a.BS];
      const uint8_t sv = a.vs[r * a.NB + d / a.BS];
      kv = mx::flush(mx::element_value(a.ke + r * a.ED, d, f, a.fmt) *
                     mx::e8m0_factor(sk));
      vv = mx::flush(mx::element_value(a.ve + r * a.ED, d, f, a.fmt) *
                     mx::e8m0_factor(sv));
    }
    kt[j * pitch + d] = kv;
    vt[j * pitch + d] = vv;
  }
}

// 8 codes of one 16-byte chunk (group `grp`) -> f32 values: fp8 words
// 2 grp and 2 grp + 1, or fp4 word grp (low nibble first); the E8M0 factor
// folded in and subnormal products flushed, into dst (16-byte aligned)
__device__ __forceinline__ void store8(const uint4& u, int grp, bool fp4,
                                       int fmt, uint8_t sc, float* dst) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float v[8];
  if (fp4) {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = mx::decode_fp4((w[grp] >> (4 * t)) & 0xFu);
  } else {
    mx::fp8x4(w[2 * grp], fmt, v);
    mx::fp8x4(w[2 * grp + 1], fmt, v + 4);
  }
  const float fac = mx::e8m0_factor(sc);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = mx::flush(v[t] * fac);
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The same from 16-byte loads (`fast`: fp8 or fp4 rows of whole 16-byte
// chunks on 16-byte bases, blocks a multiple of 8 elements, so each
// 8-element group has one E8M0 byte). A thread takes kBatch chunks of K
// and the same of V at a time, and issues every code and E8M0 load of the
// batch before it decodes any, so their latencies overlap.
__device__ inline void load_kv_fast(const DecodeArgs& a, size_t row0, int n,
                                    float* kt, float* vt) {
  constexpr int kBatch = 2;
  const bool fp4 = a.fmt == 4;
  const int pitch = tile_pitch(a.D);
  const int cpr = a.ED / 16;          // chunks of a row
  const int groups = fp4 ? 4 : 2;     // 8-element groups of a chunk
  const int total = n * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    uint4 uk[kBatch], uv[kBatch];
    uint8_t sk[kBatch][4], sv[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= total) break;
      const int j = i / cpr, c = i % cpr;
      const size_t r = row0 + j;
      uk[b] = reinterpret_cast<const uint4*>(a.ke + r * a.ED)[c];
      uv[b] = reinterpret_cast<const uint4*>(a.ve + r * a.ED)[c];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g >= groups) break;
        const size_t sidx = r * a.NB + (c * 8 * groups + 8 * g) / a.BS;
        sk[b][g] = a.ks[sidx];
        sv[b][g] = a.vs[sidx];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= total) break;
      const int j = i / cpr, c = i % cpr;
      const int e0 = c * 8 * groups;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g >= groups) break;
        store8(uk[b], g, fp4, a.fmt, sk[b][g], kt + j * pitch + e0 + 8 * g);
        store8(uv[b], g, fp4, a.fmt, sv[b][g], vt + j * pitch + e0 + 8 * g);
      }
    }
  }
  // no columns beyond D on this path (D a multiple of 16)
}

// One CTA per (split, cell): the split's keys [t0, t0 + n), in the
// reference's order within it. Logits in f32 (one FMA chain over D each,
// times d^-0.5, softcapped, masked keys at the finite NEG_INF), then the
// split's max m_s over its keys (masked ones included), p = exp(l - m_s),
// l_s = sum p and o_s = p @ V, all written to the workspace unnormalised.
template <class QT>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, cell = blockIdx.y;
  const int b = cell / a.KVH;
  const int G = a.G, D = a.D, chunk = a.chunk;
  const int pitch = tile_pitch(D), w = pitch - 4;
  const int t0 = split * chunk;
  const int n = min(chunk, a.T - t0);
  float* qs = smem;                                   // (G, pitch)
  float* kt = qs + G * pitch;                         // (chunk, pitch)
  float* vt = kt + chunk * pitch;                     // (chunk, pitch)
  float* lg = vt + chunk * pitch;                     // (G, chunk)
  const QT* q = static_cast<const QT*>(a.q) + static_cast<size_t>(cell) * G * D;
  for (int i = threadIdx.x; i < G * w; i += blockDim.x) {
    const int g = i / w, d = i % w;
    qs[g * pitch + d] = d < D ? load_q(q, static_cast<size_t>(g) * D + d)
                              : 0.0f;
  }
  const size_t row0 = static_cast<size_t>(cell) * a.T + t0;
  if (a.fast) {
    load_kv_fast(a, row0, n, kt, vt);
  } else {
    load_kv_rows(a, row0, n, kt, vt);
  }
  __syncthreads();

  const int* kpos = a.kpos + static_cast<size_t>(b) * a.T + t0;
  const int pos = a.pos[b];
  for (int i = threadIdx.x; i < G * n; i += blockDim.x) {
    const int g = i / n, j = i % n;
    const float4* qr = reinterpret_cast<const float4*>(qs + g * pitch);
    const float4* kr = reinterpret_cast<const float4*>(kt + j * pitch);
    // four FMA chains (d mod 4), summed at the end: a quarter of the
    // dependent latency of one chain over D
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < w / 4; ++d4) {
      const float4 x = qr[d4], y = kr[d4];
      s0 = fmaf(x.x, y.x, s0);
      s1 = fmaf(x.y, y.y, s1);
      s2 = fmaf(x.z, y.z, s2);
      s3 = fmaf(x.w, y.w, s3);
    }
    float s = ((s0 + s1) + (s2 + s3)) * a.scale;
    if (a.softcap > 0.0f) s = tanhf(s / a.softcap) * a.softcap;
    const int kp = kpos[j];
    lg[g * chunk + j] = (kp <= pos && kp >= 0) ? s : kNegInf;
  }
  __syncthreads();

  // per query row (one warp each): m_s, p = exp(l - m_s) in place, l_s
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned kFull = 0xFFFFFFFFu;
  const size_t slot = static_cast<size_t>(cell) * a.splits + split;
  for (int g = warp; g < G; g += blockDim.x / 32) {
    float* row = lg + g * chunk;
    float m = kNegInf;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (lane == 0) {
      a.ws_ml[(slot * G + g) * 2] = m;
      a.ws_ml[(slot * G + g) * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // o_s = p @ V over the split's keys in order; with D a multiple of 4 a
  // thread owns 4 consecutive outputs of a row (one 16-byte read of V a
  // key), else one output
  float* o = a.ws_o + slot * G * D;
  if (D % 4 == 0) {
    const int d4s = D / 4;
    for (int i = threadIdx.x; i < G * d4s; i += blockDim.x) {
      const int g = i / d4s, d = 4 * (i % d4s);
      const float* p = lg + g * chunk;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(vt + j * pitch + d);
        s.x = fmaf(p[j], v.x, s.x);
        s.y = fmaf(p[j], v.y, s.y);
        s.z = fmaf(p[j], v.z, s.z);
        s.w = fmaf(p[j], v.w, s.w);
      }
      *reinterpret_cast<float4*>(o + g * D + d) = s;
    }
  } else {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const float* p = lg + (i / D) * chunk;
      const float* v = vt + i % D;
      float s = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) s = fmaf(p[j], v[j * pitch], s);
      o[i] = s;
    }
  }
}

// One CTA per (cell, query row): M = max_s m_s and the factors
// f_s = exp(m_s - M) into shared memory (one warp), then in ascending split
// order denom = sum_s l_s f_s (one thread) and, a thread per output,
// out = (sum_s o_s f_s) / denom. A row whose every key is masked has every
// m_s = NEG_INF and every factor 1: the sum of V over T divided by T, the
// reference's mean of V; a wholly masked split of a live row gets the
// factor exp(NEG_INF - M) = 0.
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const DecodeArgs a) {
  extern __shared__ float fs[];  // (S,) factors, then denom
  const int cell = blockIdx.x, g = blockIdx.y;
  const int G = a.G, D = a.D, S = a.splits;
  const float* ml = a.ws_ml + static_cast<size_t>(cell) * S * G * 2;
  const float* o = a.ws_o + static_cast<size_t>(cell) * S * G * D;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNegInf;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, ml[(s * G + g) * 2]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    }
    for (int s = lane; s < S; s += 32) fs[s] = expf(ml[(s * G + g) * 2] - m);
    __syncwarp();
    if (lane == 0) {
      float denom = 0.0f;
      for (int s = 0; s < S; ++s) {
        denom = fmaf(ml[(s * G + g) * 2 + 1], fs[s], denom);
      }
      fs[S] = denom;
    }
  }
  __syncthreads();
  float* out = a.out + (static_cast<size_t>(cell) * G + g) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.0f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      num = fmaf(o[(static_cast<size_t>(s) * G + g) * D + d], fs[s], num);
    }
    out[d] = num / fs[S];
  }
}

template <class QT>
int launch_decode(const DecodeArgs& a, int cells, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_split_kernel<QT><<<dim3(a.splits, cells), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(cells, a.G), kCombineThreads,
                          (a.splits + 1) * sizeof(float), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int fmt_bits(int fmt) { return fmt < 2 ? 8 : (fmt < 4 ? 6 : 4); }

}  // namespace

extern "C" size_t mx_attention_decode_smem_bytes(int G, int D, int chunk) {
  return decode_smem_bytes(G, D, chunk);
}

// Both launches run on `stream` and return the cudaError_t of the launch
// (0 = success). Arrays are contiguous; the table's entries are clipped
// into [0, NP) here.
extern "C" int gather_kv_pages_launch(const void* ke, const void* ks,
                                      const void* ve, const void* vs,
                                      const void* table, void* oke, void* oks,
                                      void* ove, void* ovs, int B, int P,
                                      int NP, int PS, int KVH, int ED, int NB,
                                      void* stream) {
  // grid (P, KVH, B): y and z take at most 65535 blocks
  if (NP < 1 || PS < 1 || KVH < 1 || ED < 1 || NB < 1 || B < 0 || P < 0 ||
      KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || P == 0) return 0;
  GatherArgs a;
  const void* src[4] = {ke, ks, ve, vs};
  void* dst[4] = {oke, oks, ove, ovs};
  const int width[4] = {ED, NB, ED, NB};
  for (int k = 0; k < 4; ++k) {
    a.src[k] = static_cast<const uint8_t*>(src[k]);
    a.dst[k] = static_cast<uint8_t*>(dst[k]);
    a.width[k] = width[k];
    a.vec[k] = vec_bytes(src[k], dst[k], width[k]);
  }
  a.table = static_cast<const int*>(table);
  a.P = P;
  a.NP = NP;
  a.PS = PS;
  a.KVH = KVH;
  gather_kernel<<<dim3(P, KVH, B), kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// q_f32: q holds f32 values, else bf16. fmt: the element format id
// (FORMAT_IDS), ED = D * bits / 8 bytes a row. The plan (mx_attention.
// decode_plan): `splits` CTAs of `chunk` keys a cell; ws_o and ws_ml hold
// B * KVH * splits * G * D and * 2 floats.
extern "C" int mx_attention_decode_launch(
    const void* q, int q_f32, const void* ke, const void* ks, const void* ve,
    const void* vs, const void* kpos, const void* pos, void* out, void* ws_o,
    void* ws_ml, int B, int KVH, int G, int D, int T, int ED, int block_size,
    int fmt, int splits, int chunk, float softcap, float scale,
    void* stream) {
  const int bits = fmt_bits(fmt);
  if (B < 0 || KVH < 0 || G < 1 || D < 1 || T < 1 || fmt < 0 || fmt > 4 ||
      block_size < 1 || D % block_size != 0 || ED * 8 != D * bits ||
      (block_size * bits) % 8 != 0 || chunk < 1 || splits < 1 ||
      static_cast<long long>(splits) * chunk < T ||
      static_cast<long long>(splits - 1) * chunk >= T || splits > 12000) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * KVH == 0) return 0;
  DecodeArgs a;
  a.q = q;
  a.ke = static_cast<const uint8_t*>(ke);
  a.ks = static_cast<const uint8_t*>(ks);
  a.ve = static_cast<const uint8_t*>(ve);
  a.vs = static_cast<const uint8_t*>(vs);
  a.kpos = static_cast<const int*>(kpos);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.ws_o = static_cast<float*>(ws_o);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.KVH = KVH;
  a.G = G;
  a.D = D;
  a.T = T;
  a.ED = ED;
  a.NB = D / block_size;
  a.BS = block_size;
  a.fmt = fmt;
  a.splits = splits;
  a.chunk = chunk;
  // 16-byte loads: fp8 or fp4 rows of whole 16-byte chunks on 16-byte
  // bases, blocks of 8k elements (one E8M0 byte a group of 8)
  a.fast = bits != 6 && ED % 16 == 0 && block_size % 8 == 0 &&
           (reinterpret_cast<uintptr_t>(ke) |
            reinterpret_cast<uintptr_t>(ve)) % 16 == 0;
  a.softcap = softcap;
  a.scale = scale;
  const size_t smem = decode_smem_bytes(G, D, chunk);
  return q_f32 ? launch_decode<float>(a, B * KVH, smem, stream)
               : launch_decode<__nv_bfloat16>(a, B * KVH, smem, stream);
}
