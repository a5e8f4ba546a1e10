// The MX page walk shared by the port's three attention kernels.
//
// The reference's decode/verify, chunked-prefill and ragged kernels
// (repro/kernels/mx_attention.py: _mx_attn_fused_kernel,
// _mx_attn_prefill_kernel, _mx_attn_ragged_kernel) share _dequant_rows,
// _dequant_rows_mixed and _flash_update, "so the accumulation order (and
// therefore the f32 rounding) of every fused path is identical by
// construction". This header is that shared code for Hopper: one CTA owns
// one (row, kv-head) cell and walks its pages in order.
//
//   walk_begin   stage the cell's bf16 queries, reset the softmax state;
//   walk_pages   for each page: decode its (PS, D) K and V tiles to bf16 in
//                shared memory (fp8 bytes, packed fp4 nibbles, or a mixed
//                pool's byte-row prefix under the page's own format), then
//                fold the tile into every query row's online softmax, with
//                a per-row causal (and sliding-window) mask; the next
//                page's bytes are loaded into registers while the tile is
//                folded;
//   walk_finish  hand acc / l of every row to the caller.
//
// q.k runs on the tensor cores. Every decoded element (an fp8, fp6 or fp4
// code times an E8M0 power of two, subnormals flushed) is exact in bf16, so
// q.k is bf16 mma.sync m16n8k16 with f32 sums; the tensor cores add to
// their sum with truncation, so each 16-wide step of the head dim is a
// fresh sum added to the scores with round-to-nearest. P.V sums each
// output over the page's keys in order with f32 FMAs, as the plain
// version's product does: on the tensor cores (each probability as three
// exact bf16 terms) it stayed within 1e-5 of the plain version, but
// flipped a tied logit of the two-layer megakernel check in every variant
// tried (PERF.md). A warp owns 16 query rows (padded: the cell's rows need
// not be a multiple of 16) and, where the cell has fewer than 16 row
// blocks, one slice of the head dim: it computes the block's scores over
// the page's keys (padded to 16 or 32 with zero rows), the row max and sum
// across the four lanes that share a row in the mma layout, and P.V for
// its slice into an f32 accumulator kept in shared memory in fragment
// order. The running max and denominator of a unit live in shared memory
// owned by its warp.
//
// A query row's bits depend only on its own position and the keys,
// whatever the cell's other rows are and whichever warp takes it: its
// scores come from the same mma over D in 16-wide steps, its softmax from
// the same lane order, its P.V from the same FMA chain over the page's
// keys. So a row gives the same bits in every kernel.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace mxwalk {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF
constexpr int kGroups = 4;  // 4-element groups a thread decodes of a tile
constexpr int kMaxD = 256;  // PS * D / 4 <= kGroups * kThreads at PS 32

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// slices of the head dim a row block's P.V is spread over: the warps the
// row blocks leave idle, a power of two dividing D / 16
__host__ __device__ inline int d_slices(int rows, int D) {
  const int blocks = (rows + 15) / 16;
  int ds = 1;
  while (2 * ds * blocks <= kWarps && (D / 16) % (2 * ds) == 0) ds *= 2;
  return ds;
}

// (row block, head-dim slice) units of a cell; warp w takes w, w + 16, ...
__host__ __device__ inline int walk_units(int rows, int D) {
  return (rows + 15) / 16 * d_slices(rows, D);
}

// the bf16 K tile (keys padded to 16 or 32) and queries (rows padded to
// 16), rows D + 8 apart; the f32 V tile; the f32 accumulator; a unit's max
// and denominator
__host__ __device__ inline size_t smem_bytes(int rows, int D, int PS) {
  const size_t ld = static_cast<size_t>(D) + 8;
  const size_t kp = static_cast<size_t>(round16(PS));
  const size_t rp = static_cast<size_t>(round16(rows));
  return (kp + rp) * ld * 2 + (kp + rp) * D * sizeof(float) +
         static_cast<size_t>(walk_units(rows, D)) * 32 * sizeof(float);
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
  __nv_bfloat16* kt;  // (KP, D + 8) decoded keys, rows >= PS zero
  float* vt;          // (KP, D) decoded values, rows >= PS zero
  __nv_bfloat16* q;   // (RP, D + 8) queries, rows >= rows zero
  float* acc;  // (RP / 16, D / 16, 2 rows, 32 lanes, 4) partial output
  float* ml;   // (units, 16, 2) running max and denominator
  int rows, D, PS, KP, ds, units;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lay the walk out in `smem` (smem_bytes(rows, D, PS) bytes, 16-byte
// aligned), stage the cell's queries qg (rows, D) and reset the state. The
// caller syncs before walk_pages.
__device__ inline Walk walk_begin(void* smem, const __nv_bfloat16* qg,
                                  int rows, int D, int PS) {
  Walk w;
  w.rows = rows;
  w.D = D;
  w.PS = PS;
  w.KP = round16(PS);
  w.ds = d_slices(rows, D);
  w.units = walk_units(rows, D);
  const int ld = D + 8, rp = round16(rows);
  w.kt = static_cast<__nv_bfloat16*>(smem);
  w.vt = reinterpret_cast<float*>(w.kt + w.KP * ld);
  w.q = reinterpret_cast<__nv_bfloat16*>(w.vt + w.KP * D);
  w.acc = reinterpret_cast<float*>(w.q + rp * ld);
  w.ml = w.acc + rp * D;
  // K and V tiles zero (their padding rows stay zero)
  uint4* kv = reinterpret_cast<uint4*>(w.kt);
  for (int i = threadIdx.x; i < w.KP * (2 * ld + 4 * D) / 16;
       i += blockDim.x) {
    kv[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // queries, 8 at a time (D is a multiple of 16); padding rows zero
  const bool vec = (reinterpret_cast<uintptr_t>(qg) & 15) == 0;
  for (int i = threadIdx.x; i < rp * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const __nv_bfloat16* src = qg + static_cast<size_t>(r) * D + c;
      if (vec) {
        u = *reinterpret_cast<const uint4*>(src);
      } else {
        uint16_t* h = reinterpret_cast<uint16_t*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          h[e] = *reinterpret_cast<const uint16_t*>(src + e);
        }
      }
    }
    *reinterpret_cast<uint4*>(w.q + r * ld + c) = u;
  }
  float4* acc = reinterpret_cast<float4*>(w.acc);
  for (int i = threadIdx.x; i < rp * D / 4; i += blockDim.x) {
    acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = threadIdx.x; i < w.units * 16; i += blockDim.x) {
    w.ml[2 * i] = kNegInf;
    w.ml[2 * i + 1] = 0.0f;
  }
  return w;
}

// One page's K and V bytes as loaded: per 4-element group, its codes (fp8:
// 4 bytes, fp6: 3, fp4: 2, little-endian) and its block's E8M0 byte.
struct Raw {
  uint32_t k[kGroups], v[kGroups];
  uint32_t ks, vs;  // E8M0 byte of group i at bits 8i
};

__device__ __forceinline__ uint32_t load_codes(const uint8_t* row, int d0,
                                               int bits) {
  if (bits == 8) return *reinterpret_cast<const uint32_t*>(row + d0);
  if (bits == 4) {
    return *reinterpret_cast<const uint16_t*>(row + d0 / 2);
  }
  const uint8_t* b = row + 3 * (d0 / 4);
  return static_cast<uint32_t>(b[0]) | (static_cast<uint32_t>(b[1]) << 8) |
         (static_cast<uint32_t>(b[2]) << 16);
}

// load page `page`'s K and V bytes of kv-head h under format pf; group i
// of thread t is row (t + i * kThreads) / (D / 4) of the page
__device__ inline Raw fetch_tile(const Pools& P, size_t page, int h, int pf) {
  Raw r;
  r.ks = r.vs = 0u;
  const int gpr = P.D / 4, ng = P.PS * gpr;
  const int bits = mx::fmt_spec(pf).bits;
#pragma unroll
  for (int it = 0; it < kGroups; ++it) {
    r.k[it] = r.v[it] = 0u;
    const int gi = threadIdx.x + it * kThreads;
    if (gi < ng) {
      const int j = gi / gpr, d0 = (gi % gpr) * 4;
      const size_t prow = (page * P.PS + j) * P.KVH + h;
      r.k[it] = load_codes(P.ke + prow * P.ED, d0, bits);
      r.v[it] = load_codes(P.ve + prow * P.ED, d0, bits);
      const size_t sidx = prow * P.NB + d0 / P.BS;
      r.ks |= static_cast<uint32_t>(P.ks[sidx]) << (8 * it);
      r.vs |= static_cast<uint32_t>(P.vs[sidx]) << (8 * it);
    }
  }
  return r;
}

// four codes of a group -> f32 values (exact)
__device__ __forceinline__ void decode4(uint32_t u, const mx::FmtSpec& f,
                                        int pf, bool mixed, float* v) {
  if (f.bits == 8) {
    if (mixed) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = mx::u8_fp8_value(static_cast<uint8_t>(u >> (8 * e)), f);
      }
    } else {
      mx::fp8x4(u, pf, v);
    }
  } else if (f.bits == 6) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = mx::decode_fp6((u >> (6 * e)) & 0x3Fu, f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = mx::decode_fp4((u >> (4 * e)) & 0xFu);
  }
}

// decode a fetched tile into the bf16 K and V tiles: value times its
// block's factor, flushed, exact in bf16
__device__ inline void store_tile(const Walk& w, const Pools& P, const Raw& r,
                                  int pf) {
  const mx::FmtSpec f = mx::fmt_spec(pf);
  const bool mixed = P.page_fmts != nullptr;
  const int gpr = P.D / 4, ng = P.PS * gpr, ld = P.D + 8;
#pragma unroll
  for (int it = 0; it < kGroups; ++it) {
    const int gi = threadIdx.x + it * kThreads;
    if (gi < ng) {
      const int j = gi / gpr, d0 = (gi % gpr) * 4;
      float kv[4], vv[4];
      decode4(r.k[it], f, pf, mixed, kv);
      decode4(r.v[it], f, pf, mixed, vv);
      const float kf = mx::e8m0_factor(static_cast<uint8_t>(r.ks >> (8 * it)));
      const float vf = mx::e8m0_factor(static_cast<uint8_t>(r.vs >> (8 * it)));
      uint2 ku;
      const __nv_bfloat162 k01 = __floats2bfloat162_rn(mx::flush(kv[0] * kf),
                                                       mx::flush(kv[1] * kf));
      const __nv_bfloat162 k23 = __floats2bfloat162_rn(mx::flush(kv[2] * kf),
                                                       mx::flush(kv[3] * kf));
      ku.x = *reinterpret_cast<const uint32_t*>(&k01);
      ku.y = *reinterpret_cast<const uint32_t*>(&k23);
      *reinterpret_cast<uint2*>(w.kt + j * ld + d0) = ku;
      *reinterpret_cast<float4*>(w.vt + j * P.D + d0) = make_float4(
          mx::flush(vv[0] * vf), mx::flush(vv[1] * vf), mx::flush(vv[2] * vf),
          mx::flush(vv[3] * vf));
    }
  }
}

// Fold the staged tile of page p (keys at p * PS + j) into every row's
// online softmax. Row r is query r / G at absolute position qbase +
// min(r / G, qlast); it sees keys kpos <= qpos (and, with a window,
// kpos > qpos - window). No sync: the caller syncs before the tile is
// overwritten.
template <int KP>
__device__ inline void flash_tile(const Walk& w, int p, int G, int qbase,
                                  int qlast, int window, float softcap,
                                  float scale) {
  const int D = w.D, PS = w.PS, ld = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kchunks = KP / 16;  // 16-key chunks: 1 or 2
  for (int u = threadIdx.x / 32; u < w.units; u += kWarps) {
    const int rb = u / w.ds, slice = u % w.ds;
    // scores: s[n][0..1] row g, s[n][2..3] row g + 8, keys 8n + 2t + e
    float s[KP / 8][4];
#pragma unroll
    for (int n = 0; n < KP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
    const __nv_bfloat16* qa = w.q + (rb * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const __nv_bfloat16* kb =
        w.kt + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
    // each 16-wide step of the head dim starts a fresh tensor-core sum,
    // added to the scores with round-to-nearest (the tensor cores add to
    // their sum with truncation)
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + k0);
#pragma unroll
      for (int c = 0; c < kchunks; ++c) {
        uint32_t b[4];
        ldsm_x4(b, kb + c * 16 * ld + k0);
        float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(t0, a, b[0], b[1]);
        mma_bf16(t1, a, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * c][e] += t0[e];
          s[2 * c + 1][e] += t1[e];
        }
      }
    }
    // mask, softcap, the rows' max and sum across the lanes of a row
    const int r0 = rb * 16 + g;
    int qpos[2];
    bool live[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      live[hh] = r < w.rows;
      qpos[hh] = qbase + min((live[hh] ? r : 0) / G, qlast);
    }
    uint32_t keep = 0u;  // bit 4n + 2hh + e
    float mx_[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < KP / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = i >> 1, j = 8 * n + 2 * t + (i & 1);
        const int kpos = p * PS + j;
        const bool k = live[hh] && j < PS && kpos <= qpos[hh] &&
                       (window <= 0 || kpos > qpos[hh] - window);
        float sc = s[n][i] * scale;
        if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
        s[n][i] = k ? sc : kNegInf;
        keep |= (k ? 1u : 0u) << (4 * n + i);
        mx_[hh] = fmaxf(mx_[hh], s[n][i]);
      }
    }
    float* ml = w.ml + u * 32;
    float alpha[2], m_new[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx_[hh] = fmaxf(mx_[hh], __shfl_xor_sync(0xFFFFFFFFu, mx_[hh], 1));
      mx_[hh] = fmaxf(mx_[hh], __shfl_xor_sync(0xFFFFFFFFu, mx_[hh], 2));
      const float m_prev = ml[2 * (g + 8 * hh)];
      m_new[hh] = fmaxf(m_prev, mx_[hh]);
      alpha[hh] = expf(m_prev - m_new[hh]);
    }
    // probabilities and the rows' sums
    float pr[KP / 8][4];
#pragma unroll
    for (int n = 0; n < KP / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[n][i] = (keep >> (4 * n + i)) & 1u ? expf(s[n][i] - m_new[i >> 1])
                                              : 0.0f;
        psum[i >> 1] += pr[n][i];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      psum[hh] += __shfl_xor_sync(0xFFFFFFFFu, psum[hh], 1);
      psum[hh] += __shfl_xor_sync(0xFFFFFFFFu, psum[hh], 2);
    }
    __syncwarp();  // every lane has read the unit's old max
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* row = ml + 2 * (g + 8 * hh);
        row[1] = row[1] * alpha[hh] + psum[hh];
        row[0] = m_new[hh];
      }
    }
    // P.V over the unit's slice of the head dim: each output sums the
    // page's keys in order with f32 FMAs, as the plain version's product
    // does; every probability of the thread's two rows comes from the four
    // lanes of its quad
    float pk[2][KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int src = (lane & ~3) | ((k & 7) >> 1);
      pk[0][k] = __shfl_sync(0xFFFFFFFFu, pr[k >> 3][k & 1], src);
      pk[1][k] = __shfl_sync(0xFFFFFFFFu, pr[k >> 3][2 + (k & 1)], src);
    }
    // the unit's slice: 16-column groups, thread t taking columns 4t to
    // 4t + 3 of each for its two rows, two groups at a time
    const int groups = D / 16 / w.ds, grp0 = slice * groups;
    const float* vb = w.vt + grp0 * 16 + 4 * t;
    for (int q0 = 0; q0 < groups; q0 += 2) {
      float o[2][8];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[q][e] = 0.0f;
      }
      // keys past PS (the tile's padding) add fma(0, 0, o) = o
#pragma unroll
      for (int k = 0; k < KP; ++k) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q0 + q < groups) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                vb + k * D + (q0 + q) * 16);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[q][e] = fmaf(pk[0][k], v[e], o[q][e]);
              o[q][4 + e] = fmaf(pk[1][k], v[e], o[q][4 + e]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q0 + q < groups) {
          float* ap = w.acc + (rb * (D / 16) + grp0 + q0 + q) * 256 + lane * 4;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float4 a4 = *reinterpret_cast<float4*>(ap + hh * 128);
            a4.x = a4.x * alpha[hh] + o[q][4 * hh];
            a4.y = a4.y * alpha[hh] + o[q][4 * hh + 1];
            a4.z = a4.z * alpha[hh] + o[q][4 * hh + 2];
            a4.w = a4.w * alpha[hh] + o[q][4 * hh + 3];
            *reinterpret_cast<float4*>(ap + hh * 128) = a4;
          }
        }
      }
    }
    __syncwarp();
  }
}

// Walk pages [first, valid) for kv-head h, page_of(p) the pool page of
// table entry p: pages at or past `hot_from` decode in the pool's own
// format (a prefill's chunk pages), the rest under page_format. Every
// thread of the CTA calls it after walk_begin's sync; it returns after a
// sync.
template <class PageOf>
__device__ inline void walk_pages(const Walk& w, const Pools& P,
                                  PageOf page_of, int h, int first,
                                  int valid, int hot_from, int G, int qbase,
                                  int qlast, int window, float softcap,
                                  float scale) {
  if (first >= valid) return;
  auto format_of = [&](int p, size_t page) {
    return p >= hot_from ? P.fmt : page_format(P, page);
  };
  auto fold = [&](int p) {
    if (w.KP == 16) {
      flash_tile<16>(w, p, G, qbase, qlast, window, softcap, scale);
    } else {
      flash_tile<32>(w, p, G, qbase, qlast, window, softcap, scale);
    }
  };
  size_t page = page_of(first);
  int pf = format_of(first, page);
  Raw raw = fetch_tile(P, page, h, pf);
  // the table entry a page ahead of the loads, so that they wait on no
  // index load
  size_t ahead = first + 1 < valid ? page_of(first + 1) : 0;
  for (int p = first; p < valid; ++p) {
    store_tile(w, P, raw, pf);
    __syncthreads();
    if (p + 1 < valid) {  // the next page's loads fly while this one folds
      page = ahead;
      const int nf = format_of(p + 1, page);
      raw = fetch_tile(P, page, h, nf);
      if (p + 2 < valid) ahead = page_of(p + 2);
      fold(p);
      pf = nf;
    } else {
      fold(p);
    }
    __syncthreads();
  }
}

// store(i, acc / l) for elements i to i + 3 (i = row * D + d, d a multiple
// of 4) of every row of the cell, as a float4
template <class Store>
__device__ inline void walk_finish(const Walk& w, Store store) {
  const int D = w.D, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, groups = D / 16 / w.ds;
  for (int u = threadIdx.x / 32; u < w.units; u += kWarps) {
    const int rb = u / w.ds, slice = u % w.ds;
    const float* ml = w.ml + u * 32;
    for (int q = 0; q < groups; ++q) {
      const int grp = slice * groups + q;
      const float* ap = w.acc + (rb * (D / 16) + grp) * 256 + lane * 4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rb * 16 + g + 8 * hh;
        if (row >= w.rows) continue;
        const float l = ml[2 * (g + 8 * hh) + 1];
        const float4 a4 = *reinterpret_cast<const float4*>(ap + hh * 128);
        store(row * D + grp * 16 + 4 * t,
              make_float4(a4.x / l, a4.y / l, a4.z / l, a4.w / l));
      }
    }
  }
}

// Host-side check of a launch's pool geometry; false: the kernel cannot
// take it. A mixed pool (page_fmts set) holds D-byte rows and an fp8 base
// format; a uniform pool ED = D * bits / 8 bytes of fp8 or packed fp4.
// The tile takes D a multiple of 16 up to kMaxD, pages of up to 32 rows
// and blocks of a multiple of 4 elements up to 32 (a warp's lanes).
inline bool pools_ok(const void* page_fmts, int D, int ED, int PS,
                     int block_size, int fmt) {
  const int bits = fmt < 2 ? 8 : (fmt < 4 ? 6 : 4);
  const bool ok_width = page_fmts != nullptr
                            ? ED == D && bits == 8
                            : ED * 8 == D * bits && bits != 6;
  return PS <= 32 && PS > 0 && D % 16 == 0 && D > 0 && D <= kMaxD &&
         block_size > 0 && block_size % 4 == 0 && block_size <= 32 &&
         D % block_size == 0 &&
         ok_width;
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
