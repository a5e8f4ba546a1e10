// One (row, kv-head) cell of the ragged engine step, shared by the ragged
// kernel (mx_attention_ragged.cu) and the layer-fused megakernel
// (mx_megakernel.cu), so that a cell gives the same bits in both.
//
// The reference's megakernel (repro/kernels/mx_megakernel.py::
// _mx_megakernel) runs the ragged kernel's page walk "verbatim" inside its
// (layer, row, kv-head) cells by importing the same helpers; this header is
// that sharing for Hopper. Per cell, one CTA of mxwalk::kThreads threads:
//   1. quantize-merge the row's new wide K/V rows into the write-window
//      pages [row_start / PS, ceil(seq_len / PS)), touching only the bytes
//      of rows row_start <= kpos < seq_len (the trash-page rule: a -1
//      table entry names page NP - 1, so an inactive row's writes land
//      there and nowhere else), one warp a block;
//   2. __syncthreads (which also orders the CTA's global writes before its
//      reads);
//   3. walk the cell's W * G query rows a tile at a time: tokens [t0, t0 +
//      T) (T * G rows, the last tile shorter when T does not divide W) are
//      staged and their softmax state reset (mxwalk::walk_begin), pages
//      [first_window_page, ceil(seq_len / PS)) folded in order
//      (mxwalk::walk_pages), and acc / l of every row of the tile handed to
//      `store` (mxwalk::walk_finish); then a sync before the next tile
//      reuses shared memory;
//   4. return the number of pages walked (a cell's, whatever its tiles).
// The walk's shared memory grows with its query rows (mxwalk::smem_bytes),
// so the host picks T to fit a block's 232,448 bytes: W tokens when the
// whole cell fits (one tile, the one-chunk step), else the largest multiple
// of 16 that does (mx_attention.query_tile). A tile starts on a token, so
// each query row keeps its own position; a tile of padding tokens alone
// (t >= n_new) walks the same pages as the others, its queries clamped onto
// the last real position, as an untiled walk would. A row's bits depend on
// its own position and the keys alone (mx_attention_walk.cuh), so they do
// not depend on T either.
// The reference guarantees that write-window pages belong to one row alone,
// and one CTA runs all the tiles of a cell after all its writes, so cells
// never synchronise with each other.
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
  const int* table;      // (R, P); entries < 0 name the trash page NP - 1
  const int* row_start;  // (R,)
  const int* seq_lens;   // (R,), clamped here to [start + 1, start + W]
  int R, W, G, P, NP, window;
  int T;  // tokens of a query tile, 1 <= T <= W (T == W: one tile)
  float softcap, scale;
};

// Run cell `cell` = r * KVH + h over the queries qg (W * G, D) bf16, rows
// ordered (token, group member). store(i, v) receives elements i to i + 3
// (i = row * D + d, row of the cell) of the f32 output acc / l as a float4.
// Returns the pages walked. Every thread of the CTA calls it; `smem` holds
// mxwalk::smem_bytes(T * G, D, PS) bytes.
template <class Store>
__device__ inline int ragged_cell(const Cell& a, void* smem,
                                  const __nv_bfloat16* qg, int cell,
                                  Store store) {
  const mxwalk::Pools& P = a.pools;
  const int r = cell / P.KVH, h = cell % P.KVH;

  // the wrapper's normalisation (mx_attention.normalize_rows), idempotent
  const int start = a.row_start[r];
  const int seq_len = min(max(a.seq_lens[r], start + 1), start + a.W);
  const int n_new = seq_len - start;
  const int valid = min((seq_len + P.PS - 1) / P.PS, a.P);
  const int first = mxwalk::first_window_page(start, a.window, P.PS);
  const int* trow = a.table + static_cast<size_t>(r) * a.P;
  auto page_at = [&](int p) {
    const int e = trow[p];
    return static_cast<size_t>(e < 0 ? a.NP - 1 : min(e, a.NP - 1));
  };
  const mx::FmtSpec f = mx::fmt_spec(P.fmt);

  // quantize-merge this step's new rows into the write window, one warp a
  // block: job (t, K or V, block) of new row t at kpos = start + t (rows
  // at positions below 0 or on pages past the table stay unwritten); a
  // warp loads four blocks' values before it encodes them
  const int t0 = max(0, -start), t1 = min(n_new, valid * P.PS - start);
  const int njobs = max(0, t1 - t0) * 2 * P.NB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  auto job_block = [&](int job, uint8_t*& out, uint8_t*& sc) {
    const int t = t0 + job / (2 * P.NB), rest = job % (2 * P.NB);
    const bool is_v = rest >= P.NB;
    const int b = is_v ? rest - P.NB : rest;
    const int kpos = start + t;
    const size_t prow =
        (page_at(kpos / P.PS) * P.PS + kpos % P.PS) * P.KVH + h;
    out = (is_v ? P.ve : P.ke) + prow * P.ED + b * P.BS * f.bits / 8;
    sc = (is_v ? P.vs : P.ks) + prow * P.NB + b;
    return (is_v ? a.v_new : a.k_new) +
           ((static_cast<size_t>(r) * a.W + t) * P.KVH + h) * P.D +
           b * P.BS;
  };
  for (int base = warp; base < njobs; base += 4 * mxwalk::kWarps) {
    float x[4];
    uint8_t *out[4], *sc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int job = base + u * mxwalk::kWarps;
      x[u] = 0.0f;
      if (job < njobs) {
        const __nv_bfloat16* src = job_block(job, out[u], sc[u]);
        if (lane < P.BS) {
          // -0.0 (and flushed negative subnormals) -> +0.0, as the
          // reference's one-hot f32 gather of the new rows gives
          const float v = mx::flush(__bfloat162float(src[lane]));
          x[u] = v == 0.0f ? 0.0f : v;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + u * mxwalk::kWarps < njobs) {
        mx::quantize_lanes(x[u], out[u], sc[u], P.BS, f);
      }
    }
  }
  __syncthreads();

  // online-softmax page walk, a query tile at a time; padding queries
  // (t >= n_new) clamp onto the last real position: qlast counts from the
  // tile's first token and is negative in a tile of padding alone
  for (int tile = 0; tile < a.W; tile += a.T) {
    const int rows = min(a.T, a.W - tile) * a.G;
    const int off = tile * a.G * P.D;  // the tile's first element of qg
    const mxwalk::Walk w = mxwalk::walk_begin(smem, qg + off, rows, P.D,
                                              P.PS);
    __syncthreads();
    mxwalk::walk_pages(w, P, page_at, h, first, valid, a.P, a.G,
                       start + tile, n_new - 1 - tile, a.window, a.softcap,
                       a.scale);
    mxwalk::walk_finish(w, [&](int i, float4 v) { store(off + i, v); });
    __syncthreads();  // the next tile reuses shared memory
  }
  return max(0, valid - first);
}

}  // namespace mxcell
