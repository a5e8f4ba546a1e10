// One (row, kv-head) cell of the ragged engine step, shared by the ragged
// kernel (mx_attention_ragged.cu) and the layer-fused megakernel
// (mx_megakernel.cu), so that a cell gives the same bits in both.
//
// The reference's megakernel (repro/kernels/mx_megakernel.py::
// _mx_megakernel) runs the ragged kernel's page walk "verbatim" inside its
// (layer, row, kv-head) cells by importing the same helpers; this header is
// that sharing for Hopper. Per cell, one CTA of mxwalk::kThreads threads:
//   1. stage the cell's bf16 queries (rows = W * G) and reset the softmax
//      state (mxwalk::walk_begin);
//   2. quantize-merge the row's new wide K/V rows into the write-window
//      pages [row_start / PS, ceil(seq_len / PS)), touching only the bytes
//      of rows row_start <= kpos < seq_len (the trash-page rule: a -1
//      table entry was mapped onto page NP - 1 by the caller, so an
//      inactive row's writes land there and nowhere else);
//   3. __syncthreads (which also orders the CTA's global writes before its
//      reads), then walk pages [first_window_page, ceil(seq_len / PS)) in
//      order (mxwalk::load_tile, mxwalk::flash_tile);
//   4. hand acc / l of every query row to `store` and return the number of
//      pages walked.
// The reference guarantees that write-window pages belong to one row alone,
// so cells never synchronise with each other.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_attention_walk.cuh"
#include "mx_codec.cuh"

namespace mxcell {

struct Cell {
  const __nv_bfloat16* k_new;  // (R, W, KVH, D) RoPE'd new keys
  const __nv_bfloat16* v_new;  // (R, W, KVH, D) new values
  mxwalk::Pools pools;
  const int* table;      // (R, P), already mapped into [0, NP)
  const int* row_start;  // (R,)
  const int* seq_lens;   // (R,), clamped to [row_start + 1, row_start + W]
  int R, W, G, P, window;
  float softcap, scale;
};

// Run cell `cell` = r * KVH + h over the queries qg (W * G, D) bf16, rows
// ordered (token, group member). store(i, v) receives element i = row * D
// + d of the f32 output acc / l. Returns the pages walked. Every thread of
// the CTA calls it; `smem` holds mxwalk::smem_bytes(W * G, D, PS) bytes.
template <class Store>
__device__ inline int ragged_cell(const Cell& a, float* smem,
                                  const __nv_bfloat16* qg, int cell,
                                  Store store) {
  const mxwalk::Pools& P = a.pools;
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

  const mxwalk::Walk w = mxwalk::walk_begin(smem, qg, rows, P.D, P.PS);

  // quantize-merge this step's new rows into the write window
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

  // online-softmax page walk; padding queries (t >= n_new) clamp onto the
  // last real position
  for (int p = first; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    mxwalk::load_tile(w, P, page, h, mxwalk::page_format(P, page));
    mxwalk::flash_tile(w, p, a.G, start, n_new - 1, a.window, a.softcap,
                       a.scale);
  }
  for (int i = threadIdx.x; i < rows * P.D; i += blockDim.x) {
    store(i, w.acc[i] / w.l[i / P.D]);
  }
  return max(0, valid - first);
}

}  // namespace mxcell
