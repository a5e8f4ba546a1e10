// The split engine step's MX page-walk kernels: decode/verify and chunked
// prefill.
//
// Replace the TPU kernels of repro/kernels/mx_attention.py:
//   * mx_attention_verify_fused (kernel body _mx_attn_fused_kernel, one
//     pallas_call over the grid (B, KVH, P)) and its Tq == 1 wrapper
//     mx_attention_decode_fused: a read-only walk of pages
//     [first_window_page(seq_len - Tq), ceil(seq_len / PS)) for Tq queries
//     per slot, query i at position seq_len - Tq + i. The host wrote the
//     step's K/V into the pages before the call.
//   * mx_attention_prefill_fused (_mx_attn_prefill_kernel): one
//     page-aligned chunk of C tokens per row. Pages below c0 = start / PS
//     are resident and read as in the verify kernel; pages
//     [c0, ceil(seq_len / PS)) are the chunk's own: the kernel quantizes
//     each one's whole (PS, D) wide tile -- padding rows of a final chunk
//     included, as the reference does -- writes codes and E8M0 scales into
//     the pool, and attends them. Pages past seq_len are neither read nor
//     written. Query i sits at start + i.
//
// Design. As the ragged kernel (mx_attention_ragged.cu): one CTA per
// (row, kv-head) cell loops over its own pages in order, in place of the
// TPU's sequential page axis, and runs the shared walk of
// mx_attention_walk.cuh, so a decode row here gives the ragged kernel's
// bits over the same pool. Prefill: all chunk-page writes of a CTA come
// first, then __syncthreads (which also orders the CTA's global writes
// before its reads), then the walk reads them back like any page. The
// reference's contract makes chunk pages exclusive to their row (resident
// pages may be shared read-only), so CTAs never synchronise. A chunk page
// of a mixed (tiered) pool is written and read in the hot fp8 format; its
// resident pages decode under their own format ids.
//
// The walk's shared memory grows with its query rows (mxwalk::smem_bytes),
// and a chunk's C * G rows can outgrow a block's 232,448 bytes
// (mixtral-8x22b: C 64, G 6, 384 rows of head_dim 128 need 316,672). So
// the prefill cell walks its queries in tiles of T tokens, as the ragged
// cell does (mx_attention_ragged_cell.cuh): every tile walks the same pages
// in the same CTA after all the chunk's writes, and a query row's bits
// depend on its own position and the keys alone, so any T gives the bits
// of one tile (T == C). The host picks T (mx_attention.query_tile): C where
// the whole chunk fits, else the largest multiple of 16 that does. A
// verify cell's Tq * G rows are few (30 at Tq 5, G 6) and walk in one.
//
// What bounds them on an H100 SXM (data-sheet peaks). Decode at granite
// shapes (B=8, KVH=8, G=4, D=128, PS=16, ~20 resident pages a slot) reads
// ~2.6 MB of compact pages: under a microsecond at 3.35 TB/s. Its time is
// latency: 64 CTAs, each walking ~20 pages one after the other with two
// barriers a page. A prefill chunk (C=64, rows 256) is bound like the
// ragged kernel by its products. Both run the walk's tile (q.k on bf16
// mma.sync, P.V as f32 FMAs in key order) with the next page's loads in
// flight while a page folds; a cell's pages are not split over CTAs.
// chip_smoke.py times both kernels beside their bounds (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_attention_walk.cuh"
#include "mx_codec.cuh"

namespace {

struct VerifyArgs {
  const __nv_bfloat16* q;  // (B, KVH, Tq*G, D)
  mxwalk::Pools pools;
  const int* table;     // (B, P), already mapped into [0, NP)
  const int* seq_lens;  // (B,), clamped to >= Tq
  float* out;           // (B, KVH, Tq*G, D)
  int* visits;          // (B, KVH)
  int Tq, G, P, window;
  float softcap, scale;
};

__global__ void __launch_bounds__(mxwalk::kThreads)
    verify_kernel(const VerifyArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mxwalk::Pools& P = a.pools;
  const int cell = blockIdx.x;
  const int b = cell / P.KVH, h = cell % P.KVH;
  const int rows = a.Tq * a.G;
  const int seq_len = a.seq_lens[b];
  const int qbase = seq_len - a.Tq;  // query i sits at qbase + i
  const int valid = min((seq_len + P.PS - 1) / P.PS, a.P);
  const int first = mxwalk::first_window_page(qbase, a.window, P.PS);
  const int* trow = a.table + static_cast<size_t>(b) * a.P;
  auto page_of = [&](int p) { return static_cast<size_t>(trow[p]); };

  const mxwalk::Walk w = mxwalk::walk_begin(
      smem, a.q + static_cast<size_t>(cell) * rows * P.D, rows, P.D, P.PS);
  __syncthreads();
  mxwalk::walk_pages(w, P, page_of, h, first, valid, a.P, a.G, qbase,
                     a.Tq - 1, a.window, a.softcap, a.scale);
  float* og = a.out + static_cast<size_t>(cell) * rows * P.D;
  mxwalk::walk_finish(w, [&](int i, float4 v) {
    *reinterpret_cast<float4*>(og + i) = v;
  });
  if (threadIdx.x == 0) a.visits[cell] = max(0, valid - first);
}

struct PrefillArgs {
  const __nv_bfloat16* q;        // (B, KVH, C*G, D)
  const __nv_bfloat16* k_chunk;  // (B, C, KVH, D)
  const __nv_bfloat16* v_chunk;  // (B, C, KVH, D)
  mxwalk::Pools pools;
  const int* table;        // (B, P), already mapped into [0, NP)
  const int* chunk_start;  // (B,), page-aligned
  const int* seq_lens;     // (B,), clamped to [start + 1, start + C]
  float* out;              // (B, KVH, C*G, D)
  int* visits;             // (B, KVH)
  int C, G, P, window;
  int T;  // tokens of a query tile, 1 <= T <= C (T == C: one tile)
  float softcap, scale;
};

__global__ void __launch_bounds__(mxwalk::kThreads)
    prefill_kernel(const PrefillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mxwalk::Pools& P = a.pools;
  const int cell = blockIdx.x;
  const int b = cell / P.KVH, h = cell % P.KVH;
  const int rows = a.C * a.G;
  const int start = a.chunk_start[b];
  const int seq_len = a.seq_lens[b];
  const int c0 = start / P.PS;
  const int valid = min((seq_len + P.PS - 1) / P.PS, a.P);
  const int first = mxwalk::first_window_page(start, a.window, P.PS);
  const int* trow = a.table + static_cast<size_t>(b) * a.P;
  auto page_of = [&](int p) { return static_cast<size_t>(trow[p]); };
  const mx::FmtSpec f = mx::fmt_spec(P.fmt);

  // phase 1: quantize the chunk's pages, every row of each (the reference
  // quantizes the whole (PS, D) tile, padding rows included), one warp a
  // block
  const int jobs_per_page = P.PS * P.NB;
  for (int p = c0; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    for (int job = threadIdx.x / 32; job < 2 * jobs_per_page;
         job += mxwalk::kWarps) {
      const bool is_v = job >= jobs_per_page;
      const int jj = is_v ? job - jobs_per_page : job;
      const int j = jj / P.NB, blk = jj % P.NB;
      const int t = (p - c0) * P.PS + j;  // chunk row
      const __nv_bfloat16* src =
          (is_v ? a.v_chunk : a.k_chunk) +
          ((static_cast<size_t>(b) * a.C + t) * P.KVH + h) * P.D +
          blk * P.BS;
      const size_t prow = (page * P.PS + j) * P.KVH + h;
      // the chunk's rows quantize as they are (signed zeros kept)
      const float x = threadIdx.x % 32 < P.BS
                          ? mx::flush(__bfloat162float(src[threadIdx.x % 32]))
                          : 0.0f;
      mx::quantize_lanes(
          x, (is_v ? P.ve : P.ke) + prow * P.ED + blk * P.BS * f.bits / 8,
          (is_v ? P.vs : P.ks) + prow * P.NB + blk, P.BS, f);
    }
  }
  __syncthreads();

  // phase 2, a query tile at a time: resident pages under their formats,
  // then the chunk's pages in the hot format; qlast counts from the tile's
  // first token
  const __nv_bfloat16* qg = a.q + static_cast<size_t>(cell) * rows * P.D;
  float* og = a.out + static_cast<size_t>(cell) * rows * P.D;
  for (int tile = 0; tile < a.C; tile += a.T) {
    const int off = tile * a.G * P.D;  // the tile's first element
    const mxwalk::Walk w = mxwalk::walk_begin(
        smem, qg + off, min(a.T, a.C - tile) * a.G, P.D, P.PS);
    __syncthreads();
    mxwalk::walk_pages(w, P, page_of, h, first, valid, c0, a.G,
                       start + tile, a.C - 1 - tile, a.window, a.softcap,
                       a.scale);
    mxwalk::walk_finish(w, [&](int i, float4 v) {
      *reinterpret_cast<float4*>(og + off + i) = v;
    });
    __syncthreads();  // the next tile reuses shared memory
  }
  if (threadIdx.x == 0) {
    a.visits[cell] = max(0, min(c0, valid) - first) + max(0, valid - c0);
  }
}

// every CTA takes kThreads threads, however few its query rows: a decode
// cell's four rows spread their P.V over the warps by head-dim slices, and
// the tile decode (and a prefill's page writes) over all of them
template <class Kernel, class KArgs>
int launch(Kernel kernel, const KArgs& a, int cells, int rows, int D, int PS,
           void* stream) {
  const size_t smem = mxwalk::smem_bytes(rows, D, PS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, mxwalk::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t mx_attention_paged_smem_bytes(int rows, int D, int PS) {
  return mxwalk::smem_bytes(rows, D, PS);
}

// Both launches run on `stream` and return the cudaError_t of the launch
// (0 = success). page_fmts null: a uniform pool of format `fmt`, ED bytes
// per row (D for fp8, D/2 for fp4); else a mixed pool (ED = D) whose
// candidate format ids are the bits of mixed_mask, mixed_default the first
// of them, and fmt the hot fp8 format.
extern "C" int mx_attention_verify_launch(
    const void* q, void* ke, void* ks, void* ve, void* vs, const void* table,
    const void* seq_lens, const void* page_fmts, void* out, void* visits,
    int B, int KVH, int Tq, int G, int D, int ED, int PS, int P,
    int block_size, int fmt, int window, int mixed_mask, int mixed_default,
    float softcap, float scale, void* stream) {
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      B * KVH == 0 || Tq < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VerifyArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pools = mxwalk::make_pools(ke, ks, ve, vs, page_fmts, KVH, D, ED, PS,
                               block_size, fmt, mixed_mask, mixed_default);
  a.table = static_cast<const int*>(table);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<float*>(out);
  a.visits = static_cast<int*>(visits);
  a.Tq = Tq;
  a.G = G;
  a.P = P;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  return launch(verify_kernel, a, B * KVH, Tq * G, D, PS, stream);
}

extern "C" int mx_attention_prefill_launch(
    const void* q, const void* k_chunk, const void* v_chunk, void* ke,
    void* ks, void* ve, void* vs, const void* table, const void* chunk_start,
    const void* seq_lens, const void* page_fmts, void* out, void* visits,
    int B, int KVH, int C, int G, int D, int ED, int PS, int P, int T,
    int block_size, int fmt, int window, int mixed_mask, int mixed_default,
    float softcap, float scale, void* stream) {
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      B * KVH == 0 || C % PS != 0 || C < 1 || T < 1 || T > C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PrefillArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_chunk = static_cast<const __nv_bfloat16*>(k_chunk);
  a.v_chunk = static_cast<const __nv_bfloat16*>(v_chunk);
  a.pools = mxwalk::make_pools(ke, ks, ve, vs, page_fmts, KVH, D, ED, PS,
                               block_size, fmt, mixed_mask, mixed_default);
  a.table = static_cast<const int*>(table);
  a.chunk_start = static_cast<const int*>(chunk_start);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<float*>(out);
  a.visits = static_cast<int*>(visits);
  a.C = C;
  a.G = G;
  a.P = P;
  a.T = T;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  return launch(prefill_kernel, a, B * KVH, T * G, D, PS, stream);
}
