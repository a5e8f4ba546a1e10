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
// the same bits in all three. The cell body is mx_attention_ragged_cell.cuh,
// which the layer-fused megakernel (mx_megakernel.cu) runs as its phase B.
// The walk keeps its queries, their f32 accumulators and a decoded page in
// shared memory, so a cell's W * G query rows fit a block only up to a few
// hundred (granite-8b's 256 at W 64, 215,296 bytes): a wider step (several
// prompt chunks a row, W = prefill_chunk * prefill_max_chunks) walks them
// in tiles of T tokens, every tile over the same pages, one after the
// other in the same CTA. The caller picks T (mx_attention.query_tile: W
// when the cell fits, else the largest multiple of 16 tokens that does)
// and may pass a smaller one; a row's bits do not depend on it. A split of
// the tiles over CTAs would let a later tile read pages that another CTA
// of the same launch is still writing; it would need a write pass of its
// own first.
//
// What bounds it on an H100 SXM (data-sheet peaks). At the main path's
// shapes (R=8, KVH=8, W=64, G=4, D=128, PS=16, 21-page tables) one call
// reads the bf16 queries and new K/V (4.2 MB + 2 x 1 MB) and the compact
// pages it walks (1 byte per element + 1 scale byte per 32), and writes
// the f32 output (8.4 MB): ~15 MB, 4.4 us at 3.35 TB/s. Its products --
// q.k, and P.V counted as three bf16 tensor-core products of the split
// probabilities -- are ~2.0 GFLOP of the kept (query, key) pairs, ~2.0 us
// at 989 TFLOP/s. The walk (mx_attention_walk.cuh) runs q.k on mma.sync
// and P.V as f32 FMAs in key order, one CTA per cell: only R * KVH = 64
// of the 132 SMs work, each walking its pages in order, so the P.V
// multiply-adds and each page's dependent steps set the time
// (tools/profile_mx_walk.py). A step of four chunks a row (W 256) walks
// a cell's pages once a tile: four times at granite-8b's 1,024 rows, the
// padding tiles of a decode row included. Splitting a cell's pages over
// CTAs is the next lever; chip_smoke.py computes the bound and times the
// kernel (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_attention_ragged_cell.cuh"
#include "mx_attention_walk.cuh"

namespace {

struct Args {
  const __nv_bfloat16* q;  // (R, KVH, W*G, D)
  mxcell::Cell cell;
  float* out;    // (R, KVH, W*G, D)
  int* visits;   // (R, KVH)
};

__global__ void __launch_bounds__(mxwalk::kThreads)
    ragged_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cell = blockIdx.x;
  const size_t span = static_cast<size_t>(a.cell.W) * a.cell.G *
                      a.cell.pools.D;
  float* og = a.out + cell * span;
  const int visits = mxcell::ragged_cell(
      a.cell, smem, a.q + cell * span, cell,
      [&](int i, float4 v) { *reinterpret_cast<float4*>(og + i) = v; });
  if (threadIdx.x == 0) a.visits[cell] = visits;
}

}  // namespace

// shared memory of a cell walked in tiles of T tokens (T * G query rows)
extern "C" size_t mx_attention_ragged_smem_bytes(int T, int G, int D, int PS) {
  return mxwalk::smem_bytes(T * G, D, PS);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// page_fmts null: a uniform pool of format `fmt`, ED bytes per row (D for
// fp8, D/2 for fp4); else a mixed pool (ED = D) whose candidate format ids
// are the bits of mixed_mask, mixed_default the first of them. The table
// and lengths are as the caller holds them: the cell maps entries < 0 to
// the trash page NP - 1, clamps the rest into the pool and the lengths
// into [row_start + 1, row_start + W]. A cell's queries are walked in tiles
// of T tokens (T >= W: one tile).
extern "C" int mx_attention_ragged_launch(
    const void* q, const void* k_new, const void* v_new, void* ke, void* ks,
    void* ve, void* vs, const void* table, const void* row_start,
    const void* seq_lens, const void* page_fmts, void* out, void* visits,
    int R, int KVH, int W, int G, int D, int ED, int PS, int P, int NP,
    int T, int block_size, int fmt, int window, int mixed_mask,
    int mixed_default, float softcap, float scale, void* stream) {
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      R * KVH == 0 || NP < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T = T < W ? T : W;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  mxcell::Cell& c = a.cell;
  c.k_new = static_cast<const __nv_bfloat16*>(k_new);
  c.v_new = static_cast<const __nv_bfloat16*>(v_new);
  c.pools = mxwalk::make_pools(ke, ks, ve, vs, page_fmts, KVH, D, ED, PS,
                               block_size, fmt, mixed_mask, mixed_default);
  c.table = static_cast<const int*>(table);
  c.row_start = static_cast<const int*>(row_start);
  c.seq_lens = static_cast<const int*>(seq_lens);
  c.R = R;
  c.W = W;
  c.G = G;
  c.P = P;
  c.NP = NP;
  c.window = window;
  c.T = T;
  c.softcap = softcap;
  c.scale = scale;
  a.out = static_cast<float*>(out);
  a.visits = static_cast<int*>(visits);
  const size_t smem = mxwalk::smem_bytes(T * G, D, PS);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_kernel<<<R * KVH, mxwalk::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
