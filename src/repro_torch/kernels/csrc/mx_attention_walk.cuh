// The MX page walk shared by the port's three attention kernels.
//
// The reference's decode/verify, chunked-prefill and ragged kernels
// (repro/kernels/mx_attention.py: _mx_attn_fused_kernel,
// _mx_attn_prefill_kernel, _mx_attn_ragged_kernel) share _dequant_rows,
// _dequant_rows_mixed and _flash_update, "so the accumulation order (and
// therefore the f32 rounding) of every fused path is identical by
// construction". This header is that shared code for Hopper: one CTA owns
// one (row, kv-head) cell and walks its pages in order, holding the running
// max, the denominator and the (rows, D) f32 accumulator in shared memory.
//
//   walk_begin  stage the cell's bf16 queries, reset the softmax state;
//   load_tile   dequantize one page's (PS, D) K and V tiles into shared
//               memory: fp8 bytes, packed fp4 nibbles, or a mixed pool's
//               byte-row prefix under the page's own format;
//   flash_tile  fold the tile into every query row's online softmax, with
//               a per-row causal (and sliding-window) mask;
//   walk_finish write acc / l as f32.
//
// A query row's arithmetic depends only on its own position, so a row
// gives the same bits in every kernel whatever the cell's other rows are:
// a warp takes 32 / lanes_per_row rows at a time, one lane per key of the
// tile; the scores are 4-way split f32 FMA chains over D, the max and sum
// go through xor shuffles inside the row's lane group, and P.V sums the
// keys in order.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace mxwalk {

constexpr int kThreads = 512;
constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF

__host__ __device__ inline size_t smem_bytes(int rows, int D, int PS) {
  const size_t r = static_cast<size_t>(rows);
  return (2 * static_cast<size_t>(PS) * (D + 1) + 2 * r + r * D) *
             sizeof(float) +
         r * (D + 2) * sizeof(__nv_bfloat16);
}

// lanes that share one query row: the page size rounded up to a power of 2
__host__ __device__ inline int lanes_per_row(int PS) {
  int lpr = 1;
  while (lpr < PS) lpr <<= 1;
  return lpr;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// first page any query at or after qpos_min can see under a sliding window
// (window <= 0: none), the reference's _first_window_page
__device__ __forceinline__ int first_window_page(int qpos_min, int window,
                                                 int PS) {
  return window > 0 ? max(floor_div(qpos_min - window + 1, PS), 0) : 0;
}

// One layer's page pools and the format they decode under.
struct Pools {
  uint8_t* ke;  // (NP, PS, KVH, ED) element bytes
  uint8_t* ks;  // (NP, PS, KVH, NB) E8M0
  uint8_t* ve;
  uint8_t* vs;
  const int* page_fmts;  // (NP,) format ids of a mixed pool, else null
  int KVH, ED, PS, D, BS, NB;
  int fmt;                        // the pool's format (mixed: the hot fp8)
  int mixed_mask, mixed_default;  // candidate format ids of a mixed pool
};

// the format page `page` decodes under: the pool's, or its own id
__device__ __forceinline__ int page_format(const Pools& P, size_t page) {
  return P.page_fmts == nullptr
             ? P.fmt
             : mx::mixed_fmt(P.page_fmts[page], P.mixed_mask,
                             P.mixed_default);
}

// Shared-memory state of one cell.
struct Walk {
  float* kt;  // (PS, D + 1) dequantized keys
  float* vt;  // (PS, D + 1) dequantized values
  float* m;   // (rows,) running max
  float* l;   // (rows,) running denominator
  float* acc;  // (rows, D) rescaled partial output
  __nv_bfloat16* q;  // (rows, D + 2) queries
  int rows, D, PS;
};

__device__ __forceinline__ int kstride(const Walk& w) { return w.D + 1; }
__device__ __forceinline__ int qstride(const Walk& w) { return w.D + 2; }

// Lay the walk out in `smem` (smem_bytes(rows, D, PS) bytes), stage the
// cell's queries qg (rows, D) and reset the state. The caller syncs before
// the first flash_tile.
__device__ inline Walk walk_begin(float* smem, const __nv_bfloat16* qg,
                                  int rows, int D, int PS) {
  Walk w;
  w.rows = rows;
  w.D = D;
  w.PS = PS;
  w.kt = smem;
  w.vt = w.kt + PS * (D + 1);
  w.m = w.vt + PS * (D + 1);
  w.l = w.m + rows;
  w.acc = w.l + rows;
  w.q = reinterpret_cast<__nv_bfloat16*>(w.acc + rows * D);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    w.q[(i / D) * qstride(w) + i % D] = qg[i];
    w.acc[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    w.m[i] = kNegInf;
    w.l[i] = 0.0f;
  }
  return w;
}

// Dequantize page `page`'s K and V tiles of kv-head h into shared memory
// under format pf, then sync. Uniform pools hold pf's storage (fp8 bytes or
// packed fp4); mixed pools full-width byte rows whose prefix holds pf.
__device__ inline void load_tile(const Walk& w, const Pools& P, size_t page,
                                 int h, int pf) {
  const mx::FmtSpec pfs = mx::fmt_spec(pf);
  const bool mixed = P.page_fmts != nullptr;
  const int ks_ = kstride(w);
  // unrolled so that several iterations' global loads are in flight at once
#pragma unroll 4
  for (int i = threadIdx.x; i < P.PS * P.D; i += blockDim.x) {
    const int jr = i / P.D, d = i % P.D;
    const size_t prow = (page * P.PS + jr) * P.KVH + h;
    const size_t sidx = prow * P.NB + d / P.BS;
    const uint8_t* krow = P.ke + prow * P.ED;
    const uint8_t* vrow = P.ve + prow * P.ED;
    float kv, vv;
    if (mixed) {
      kv = mx::mixed_element_value(krow, d, pfs);
      vv = mx::mixed_element_value(vrow, d, pfs);
    } else if (pfs.bits == 8) {
      kv = mx::fp8_value(krow[d], pf);
      vv = mx::fp8_value(vrow[d], pf);
    } else {
      kv = mx::element_value(krow, d, pfs, pf);
      vv = mx::element_value(vrow, d, pfs, pf);
    }
    w.kt[jr * ks_ + d] = mx::flush(kv * mx::e8m0_factor(P.ks[sidx]));
    w.vt[jr * ks_ + d] = mx::flush(vv * mx::e8m0_factor(P.vs[sidx]));
  }
  __syncthreads();
}

// Fold the staged tile of page p (keys at p * PS + j) into every row's
// online softmax, then sync. Row r is query r / G at absolute position
// qbase + min(r / G, qlast); it sees keys kpos <= qpos (and, with a window,
// kpos > qpos - window).
__device__ inline void flash_tile(const Walk& w, int p, int G, int qbase,
                                  int qlast, int window, float softcap,
                                  float scale) {
  const int D = w.D, PS = w.PS, rows = w.rows;
  const int lpr = lanes_per_row(PS);
  const int rpw = 32 / lpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / lpr, j = lane % lpr;
  const int rows_per_pass = (blockDim.x / 32) * rpw;
  const int dpl = D / lpr;
  const int ks_ = kstride(w), qs_ = qstride(w);
  const unsigned kFull = 0xFFFFFFFFu;
  const int kpos = p * PS + j;
  for (int base = 0; base < rows; base += rows_per_pass) {
    const int row = base + warp * rpw + sub;
    const bool row_ok = row < rows;
    const int rr = row_ok ? row : 0;
    const int qpos = qbase + min(rr / G, qlast);
    const bool keep = row_ok && j < PS && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
    float s = kNegInf;
    if (j < PS) {
      const __nv_bfloat16* qr = w.q + rr * qs_;
      const float* kr = w.kt + j * ks_;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      int d = 0;
      for (; d + 3 < D; d += 4) {
        s0 = fmaf(__bfloat162float(qr[d]), kr[d], s0);
        s1 = fmaf(__bfloat162float(qr[d + 1]), kr[d + 1], s1);
        s2 = fmaf(__bfloat162float(qr[d + 2]), kr[d + 2], s2);
        s3 = fmaf(__bfloat162float(qr[d + 3]), kr[d + 3], s3);
      }
      for (; d < D; ++d) s0 = fmaf(__bfloat162float(qr[d]), kr[d], s0);
      float sc = ((s0 + s1) + (s2 + s3)) * scale;
      if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
      if (keep) s = sc;
    }
    const float m_prev = w.m[rr];
    float mx_ = s;
    for (int off = lpr / 2; off > 0; off >>= 1) {
      mx_ = fmaxf(mx_, __shfl_xor_sync(kFull, mx_, off, lpr));
    }
    const float m_new = fmaxf(m_prev, mx_);
    const float alpha = expf(m_prev - m_new);
    const float pr = keep ? expf(s - m_new) : 0.0f;
    float psum = pr;
    for (int off = lpr / 2; off > 0; off >>= 1) {
      psum += __shfl_xor_sync(kFull, psum, off, lpr);
    }
    for (int k = 0; k < dpl; ++k) {
      const int d = k * lpr + j;
      float pv = 0.0f;
      for (int key = 0; key < PS; ++key) {
        const float pk = __shfl_sync(kFull, pr, sub * lpr + key);
        pv = fmaf(pk, w.vt[key * ks_ + d], pv);
      }
      if (row_ok) w.acc[rr * D + d] = w.acc[rr * D + d] * alpha + pv;
    }
    __syncwarp();
    if (row_ok && j == 0) {
      w.m[rr] = m_new;
      w.l[rr] = w.l[rr] * alpha + psum;
    }
    __syncwarp();
  }
  __syncthreads();
}

// acc / l of every row into og (rows, D) f32
__device__ inline void walk_finish(const Walk& w, float* og) {
  for (int i = threadIdx.x; i < w.rows * w.D; i += blockDim.x) {
    og[i] = w.acc[i] / w.l[i / w.D];
  }
}

// Host-side check of a launch's pool geometry; false: the kernel cannot
// take it. A mixed pool (page_fmts set) holds D-byte rows and an fp8 base
// format; a uniform pool ED = D * bits / 8 bytes of fp8 or packed fp4.
inline bool pools_ok(const void* page_fmts, int D, int ED, int PS,
                     int block_size, int fmt) {
  const int bits = fmt < 2 ? 8 : (fmt < 4 ? 6 : 4);
  const bool ok_width = page_fmts != nullptr
                            ? ED == D && bits == 8
                            : ED * 8 == D * bits && bits != 6;
  return PS <= 32 && PS > 0 && D % lanes_per_row(PS) == 0 &&
         D % block_size == 0 && ok_width && (block_size * bits) % 8 == 0;
}

inline Pools make_pools(void* ke, void* ks, void* ve, void* vs,
                        const void* page_fmts, int KVH, int D, int ED,
                        int PS, int block_size, int fmt, int mixed_mask,
                        int mixed_default) {
  Pools P;
  P.ke = static_cast<uint8_t*>(ke);
  P.ks = static_cast<uint8_t*>(ks);
  P.ve = static_cast<uint8_t*>(ve);
  P.vs = static_cast<uint8_t*>(vs);
  P.page_fmts = static_cast<const int*>(page_fmts);
  P.KVH = KVH;
  P.ED = ED;
  P.PS = PS;
  P.D = D;
  P.BS = block_size;
  P.NB = D / block_size;
  P.fmt = fmt;
  P.mixed_mask = mixed_mask;
  P.mixed_default = mixed_default;
  return P;
}

}  // namespace mxwalk
