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
// base addresses allow, chosen per array on the host. The decode keeps one
// CTA per cell, as the TPU grid does, and follows the reference's order:
// K streams through shared memory in tiles of kTile keys, decoded once
// (element decode, E8M0 factor, flush of subnormal products, as every
// decode in the port), and each thread forms (query row, key) logits as
// one serial f32 FMA chain over D; the (G, T) logits stay in shared memory
// (the launch is refused when G * T * 4 bytes do not fit beside the tile);
// each warp reduces its query rows' max and sum with shuffles; V streams
// through the same tile buffer, and each thread owns (row, d) outputs,
// summing p * v over the keys in order.
//
// What bounds them on an H100 SXM (data-sheet peaks). Both move bytes and
// do little arithmetic: at granite-8b shapes (B 8, KVH 8, D 128, 21 pages
// of 16 rows, fp8) the gather reads and writes ~5.7 MB each way and the
// decode moves ~5.9 MB, a few microseconds at 3.35 TB/s; the decode's
// 2 * G * T * D multiply-adds per cell are a few MFLOP. This first version
// is right and simple (64 CTAs for the decode, scalar loops from shared
// memory); chip_smoke.py times both beside their bounds (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kGatherThreads = 128;
constexpr int kThreads = 256;
constexpr int kTile = 64;  // keys per K/V tile of the decode
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
  int KVH, G, D, T, ED, NB, BS, fmt;
  float softcap, scale;
};

__host__ __device__ inline size_t decode_smem_bytes(int G, int T, int D) {
  return (static_cast<size_t>(G) * T + static_cast<size_t>(kTile) * (D + 1) +
          2 * static_cast<size_t>(G) * D + G) *
         sizeof(float);
}

__device__ __forceinline__ float load_q(const __nv_bfloat16* q, size_t i) {
  return __bfloat162float(q[i]);
}
__device__ __forceinline__ float load_q(const float* q, size_t i) {
  return q[i];
}

// Dequantize keys [t0, t0 + n) of the cell's (T, ED) rows into the (n, D + 1)
// tile, then sync.
__device__ inline void load_tile(const DecodeArgs& a, const uint8_t* elems,
                                 const uint8_t* scales, size_t row0, int t0,
                                 int n, float* tile) {
  const mx::FmtSpec f = mx::fmt_spec(a.fmt);
  const int D = a.D;
  // unrolled so that several iterations' global loads are in flight at once
#pragma unroll 4
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int j = i / D, d = i % D;
    const size_t r = row0 + t0 + j;
    const float v = mx::element_value(elems + r * a.ED, d, f, a.fmt);
    tile[j * (D + 1) + d] =
        mx::flush(v * mx::e8m0_factor(scales[r * a.NB + d / a.BS]));
  }
  __syncthreads();
}

template <class QT>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  extern __shared__ float smem[];
  const int cell = blockIdx.x;
  const int b = cell / a.KVH;
  const int G = a.G, D = a.D, T = a.T;
  float* logits = smem;                                  // (G, T)
  float* tile = logits + static_cast<size_t>(G) * T;     // (kTile, D + 1)
  float* qs = tile + kTile * (D + 1);                    // (G, D)
  float* acc = qs + G * D;                               // (G, D)
  float* denom = acc + G * D;                            // (G,)
  const QT* q = static_cast<const QT*>(a.q) + static_cast<size_t>(cell) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    qs[i] = load_q(q, i);
    acc[i] = 0.0f;
  }
  const size_t row0 = static_cast<size_t>(cell) * T;
  const int* kpos = a.kpos + static_cast<size_t>(b) * T;
  const int pos = a.pos[b];

  // logits over every key, masked keys at NEG_INF
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    load_tile(a, a.ke, a.ks, row0, t0, n, tile);  // syncs (qs staged too)
    for (int i = threadIdx.x; i < G * n; i += blockDim.x) {
      const int g = i / n, j = i % n;
      const float* qr = qs + g * D;
      const float* kr = tile + j * (D + 1);
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= a.scale;
      if (a.softcap > 0.0f) s = tanhf(s / a.softcap) * a.softcap;
      const int kp = kpos[t0 + j];
      logits[g * T + t0 + j] = (kp <= pos && kp >= 0) ? s : kNegInf;
    }
    __syncthreads();
  }

  // per query row: m = max over T, p = exp(l - m) in place, denom = sum p
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned kFull = 0xFFFFFFFFu;
  for (int g = warp; g < G; g += blockDim.x / 32) {
    float* row = logits + static_cast<size_t>(g) * T;
    float m = kNegInf;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, row[t]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float p = expf(row[t] - m);
      row[t] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (lane == 0) denom[g] = sum;
  }
  __syncthreads();

  // p @ V over the keys in order, divided by the sum after the product
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    load_tile(a, a.ve, a.vs, row0, t0, n, tile);
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* p = logits + static_cast<size_t>(g) * T + t0;
      float s = acc[i];
      for (int j = 0; j < n; ++j) s = fmaf(p[j], tile[j * (D + 1) + d], s);
      acc[i] = s;
    }
    __syncthreads();
  }
  float* out = a.out + static_cast<size_t>(cell) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    out[i] = acc[i] / denom[i / D];
  }
}

template <class QT>
int launch_decode(const DecodeArgs& a, int cells, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<QT><<<cells, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int fmt_bits(int fmt) { return fmt < 2 ? 8 : (fmt < 4 ? 6 : 4); }

}  // namespace

extern "C" size_t mx_attention_decode_smem_bytes(int G, int T, int D) {
  return decode_smem_bytes(G, T, D);
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
// (FORMAT_IDS), ED = D * bits / 8 bytes a row.
extern "C" int mx_attention_decode_launch(
    const void* q, int q_f32, const void* ke, const void* ks, const void* ve,
    const void* vs, const void* kpos, const void* pos, void* out, int B,
    int KVH, int G, int D, int T, int ED, int block_size, int fmt,
    float softcap, float scale, void* stream) {
  const int bits = fmt_bits(fmt);
  if (B < 0 || KVH < 0 || G < 1 || D < 1 || T < 1 || fmt < 0 || fmt > 4 ||
      block_size < 1 || D % block_size != 0 || ED * 8 != D * bits ||
      (block_size * bits) % 8 != 0) {
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
  a.KVH = KVH;
  a.G = G;
  a.D = D;
  a.T = T;
  a.ED = ED;
  a.NB = D / block_size;
  a.BS = block_size;
  a.fmt = fmt;
  a.softcap = softcap;
  a.scale = scale;
  const size_t smem = decode_smem_bytes(G, T, D);
  return q_f32 ? launch_decode<float>(a, B * KVH, smem, stream)
               : launch_decode<__nv_bfloat16>(a, B * KVH, smem, stream);
}
