// Ragged MX page-walk attention with the in-kernel K/V page write.
//
// Replaces the TPU kernel repro/kernels/mx_attention.py::
// mx_attention_ragged_fused (kernel body _mx_attn_ragged_kernel, one
// pallas_call over the grid (R, KVH, P)). One engine step's rows -- a decode
// token, a verify window, or a prefill chunk -- each carry (row_start,
// seq_len); per (row, kv-head) the kernel
//   1. quantizes the row's new wide K/V rows to MX codes + E8M0 and merges
//      them into the write-window pages [row_start / PS, ceil(seq_len / PS)),
//      touching only the bytes of rows row_start <= kpos < seq_len;
//   2. walks pages [first_window_page, ceil(seq_len / PS)) in order,
//      dequantizing each K/V page tile into shared memory and folding it
//      into a per-query-row online softmax (the reference's _flash_update);
//   3. writes acc / l as f32 and the number of pages it visited.
//
// Pools. Uniform fp8 pools hold one byte per element (ED = D); uniform fp4
// pools two nibbles per byte (ED = D/2), encoded and packed by the write
// and decoded in registers by the walk. A page row is one token's whole
// row, so the code-domain merge never splits a byte between old and new
// rows. Mixed-format (tiered) pools hold full-width uint8 rows (ED = D):
// a page's codes fill the row prefix in the format page_fmts[page] names
// (the reference's _dequant_rows_mixed), and the write lands fmt's fp8
// bytes. The engine guarantees that write-window pages are in that base
// format; the kernel decodes every page under its id and fixes nothing.
// Design. On the TPU the page axis is a sequential grid dimension carrying
// the softmax state in VMEM scratch. CTAs on Hopper run in no order, so one
// CTA owns one (row, kv-head) cell and loops over its pages; the reference
// guarantees write-window pages belong to one row alone, so CTAs never
// synchronise. Within a CTA: all writes first, then __syncthreads (which
// also orders the CTA's global writes before its reads), then the page
// walk of mx_attention_walk.cuh, the device code the decode/verify and
// chunked-prefill kernels (mx_attention_paged.cu) run too, so a row gives
// the same bits in all three.
//
// What bounds it on an H100 SXM (data-sheet peaks). At the main path's
// shapes (R=8, KVH=8, W=64, G=4, D=128, PS=16, 21-page tables) one call
// reads the bf16 queries and new K/V (4.2 MB + 2 x 1 MB) and the compact
// pages it walks (1 byte per element + 1 scale byte per 32), and writes
// the f32 output (8.4 MB): ~15 MB, 4.4 us at 3.35 TB/s. The f32
// probabilities x values product (0.57 GFLOP at 67 TFLOP/s) bounds it
// harder, at ~9 us; q.k could run on bf16 tensor cores exactly, since
// dequantized fp8 values are exact in bf16. This first version is right
// and simple: one CTA per cell, so only R * KVH = 64 of the 132 SMs work,
// and scalar f32 dot products from shared memory, no wgmma. Splitting a
// cell's pages over CTAs and tensor-core q.k are the levers for a later
// change; chip_smoke.py computes the bound and times the kernel (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_attention_walk.cuh"
#include "mx_codec.cuh"

namespace {

struct Args {
  const __nv_bfloat16* q;      // (R, KVH, W*G, D)
  const __nv_bfloat16* k_new;  // (R, W, KVH, D)
  const __nv_bfloat16* v_new;  // (R, W, KVH, D)
  mxwalk::Pools pools;
  const int* table;      // (R, P), already mapped into [0, NP)
  const int* row_start;  // (R,)
  const int* seq_lens;   // (R,), clamped to [row_start + 1, row_start + W]
  float* out;            // (R, KVH, W*G, D)
  int* visits;           // (R, KVH)
  int R, W, G, P, window;
  float softcap, scale;
};

__global__ void __launch_bounds__(mxwalk::kThreads)
    ragged_kernel(const Args a) {
  extern __shared__ float smem[];
  const mxwalk::Pools& P = a.pools;
  const int cell = blockIdx.x;
  const int r = cell / P.KVH, h = cell % P.KVH;
  const int rows = a.W * a.G;

  const int start = a.row_start[r];
  const int seq_len = a.seq_lens[r];
  const int n_new = seq_len - start;
  const int w0 = max(start, 0) / P.PS;
  const int valid = min((seq_len + P.PS - 1) / P.PS, a.P);
  const int first = mxwalk::first_window_page(start, a.window, P.PS);
  const int* trow = a.table + static_cast<size_t>(r) * a.P;
  const mx::FmtSpec f = mx::fmt_spec(P.fmt);

  const mxwalk::Walk w = mxwalk::walk_begin(
      smem, a.q + static_cast<size_t>(cell) * rows * P.D, rows, P.D, P.PS);

  // phase 1: quantize-merge this step's new rows into the write window
  const int jobs_per_page = P.PS * P.NB;
  for (int p = w0; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    for (int job = threadIdx.x; job < 2 * jobs_per_page; job += blockDim.x) {
      const bool is_v = job >= jobs_per_page;
      const int jj = is_v ? job - jobs_per_page : job;
      const int j = jj / P.NB, b = jj % P.NB;
      const int kpos = p * P.PS + j;
      if (kpos < start || kpos >= seq_len) continue;  // bytes stay untouched
      const int t = kpos - start;
      const __nv_bfloat16* src =
          (is_v ? a.v_new : a.k_new) +
          ((static_cast<size_t>(r) * a.W + t) * P.KVH + h) * P.D + b * P.BS;
      const size_t prow = (page * P.PS + j) * P.KVH + h;
      mx::quantize_block(
          src, (is_v ? P.ve : P.ke) + prow * P.ED + b * P.BS * f.bits / 8,
          (is_v ? P.vs : P.ks) + prow * P.NB + b, P.BS, f,
          /*plus_zero=*/true);
    }
  }
  __syncthreads();

  // phase 2: online-softmax page walk; padding queries (t >= n_new) clamp
  // onto the last real position
  for (int p = first; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    mxwalk::load_tile(w, P, page, h, mxwalk::page_format(P, page));
    mxwalk::flash_tile(w, p, a.G, start, n_new - 1, a.window, a.softcap,
                       a.scale);
  }
  mxwalk::walk_finish(w, a.out + static_cast<size_t>(cell) * rows * P.D);
  if (threadIdx.x == 0) a.visits[cell] = max(0, valid - first);
}

}  // namespace

extern "C" size_t mx_attention_ragged_smem_bytes(int W, int G, int D, int PS) {
  return mxwalk::smem_bytes(W * G, D, PS);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// page_fmts null: a uniform pool of format `fmt`, ED bytes per row (D for
// fp8, D/2 for fp4); else a mixed pool (ED = D) whose candidate format ids
// are the bits of mixed_mask, mixed_default the first of them.
extern "C" int mx_attention_ragged_launch(
    const void* q, const void* k_new, const void* v_new, void* ke, void* ks,
    void* ve, void* vs, const void* table, const void* row_start,
    const void* seq_lens, const void* page_fmts, void* out, void* visits,
    int R, int KVH, int W, int G, int D, int ED, int PS, int P,
    int block_size, int fmt, int window, int mixed_mask, int mixed_default,
    float softcap, float scale, void* stream) {
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      R * KVH == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.pools = mxwalk::make_pools(ke, ks, ve, vs, page_fmts, KVH, D, ED, PS,
                               block_size, fmt, mixed_mask, mixed_default);
  a.table = static_cast<const int*>(table);
  a.row_start = static_cast<const int*>(row_start);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<float*>(out);
  a.visits = static_cast<int*>(visits);
  a.R = R;
  a.W = W;
  a.G = G;
  a.P = P;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  const size_t smem = mxwalk::smem_bytes(W * G, D, PS);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_kernel<<<R * KVH, mxwalk::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
