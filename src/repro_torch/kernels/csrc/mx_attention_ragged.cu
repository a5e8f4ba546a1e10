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
// walk. A warp takes 32 / lanes_per_row query rows at a time, one lane per
// key of the page tile; the running max, denominator and (rows, D) f32
// accumulator live in shared memory for the whole walk.
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

#include "mx_codec.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF

struct Args {
  const __nv_bfloat16* q;      // (R, KVH, W*G, D)
  const __nv_bfloat16* k_new;  // (R, W, KVH, D)
  const __nv_bfloat16* v_new;  // (R, W, KVH, D)
  uint8_t* ke;                 // (NP, PS, KVH, ED) element bytes
  uint8_t* ks;                 // (NP, PS, KVH, NB) E8M0
  uint8_t* ve;
  uint8_t* vs;
  const int* table;      // (R, P), already mapped into [0, NP)
  const int* row_start;  // (R,)
  const int* seq_lens;   // (R,), clamped to [row_start + 1, row_start + W]
  const int* page_fmts;  // (NP,) format ids of a mixed pool, else null
  float* out;            // (R, KVH, W*G, D)
  int* visits;           // (R, KVH)
  int R, KVH, W, G, D, ED, PS, P, BS, NB, fmt, window, lanes_per_row;
  int mixed_mask, mixed_default;  // candidate format ids of a mixed pool
  float softcap, scale;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(kThreads) ragged_kernel(const Args a) {
  extern __shared__ float smem[];
  const int cell = blockIdx.x;
  const int r = cell / a.KVH, h = cell % a.KVH;
  const int rows = a.W * a.G;
  const int kstride = a.D + 1;  // odd stride: lanes on different keys hit
                                // different banks
  const int qstride = a.D + 2;
  float* kt = smem;
  float* vt = kt + a.PS * kstride;
  float* m_s = vt + a.PS * kstride;
  float* l_s = m_s + rows;
  float* acc = l_s + rows;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(acc + rows * a.D);

  const int start = a.row_start[r];
  const int seq_len = a.seq_lens[r];
  const int n_new = seq_len - start;
  const int w0 = max(start, 0) / a.PS;
  const int valid = min((seq_len + a.PS - 1) / a.PS, a.P);
  const int first =
      a.window > 0 ? max(floor_div(start - a.window + 1, a.PS), 0) : 0;
  const int* trow = a.table + static_cast<size_t>(r) * a.P;
  const mx::FmtSpec f = mx::fmt_spec(a.fmt);

  const __nv_bfloat16* qg = a.q + static_cast<size_t>(cell) * rows * a.D;
  for (int i = threadIdx.x; i < rows * a.D; i += blockDim.x) {
    q_s[(i / a.D) * qstride + i % a.D] = qg[i];
    acc[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }

  // phase 1: quantize-merge this step's new rows into the write window
  const int jobs_per_page = a.PS * a.NB;
  for (int p = w0; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    for (int job = threadIdx.x; job < 2 * jobs_per_page; job += blockDim.x) {
      const bool is_v = job >= jobs_per_page;
      const int jj = is_v ? job - jobs_per_page : job;
      const int j = jj / a.NB, b = jj % a.NB;
      const int kpos = p * a.PS + j;
      if (kpos < start || kpos >= seq_len) continue;  // bytes stay untouched
      const int t = kpos - start;
      const __nv_bfloat16* src =
          (is_v ? a.v_new : a.k_new) +
          ((static_cast<size_t>(r) * a.W + t) * a.KVH + h) * a.D + b * a.BS;
      const size_t prow = (page * a.PS + j) * a.KVH + h;
      mx::quantize_block(
          src, (is_v ? a.ve : a.ke) + prow * a.ED + b * a.BS * f.bits / 8,
          (is_v ? a.vs : a.ks) + prow * a.NB + b, a.BS, f);
    }
  }
  __syncthreads();

  // phase 2: online-softmax page walk
  const int lpr = a.lanes_per_row;
  const int rpw = 32 / lpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / lpr, j = lane % lpr;
  const int rows_per_pass = (blockDim.x / 32) * rpw;
  const int dpl = a.D / lpr;
  const unsigned kFull = 0xFFFFFFFFu;

  for (int p = first; p < valid; ++p) {
    const size_t page = static_cast<size_t>(trow[p]);
    // the format this page decodes under: the pool's, or its own id
    const int pf = a.page_fmts == nullptr
                       ? a.fmt
                       : mx::mixed_fmt(a.page_fmts[page], a.mixed_mask,
                                       a.mixed_default);
    const mx::FmtSpec pfs = mx::fmt_spec(pf);
    for (int i = threadIdx.x; i < a.PS * a.D; i += blockDim.x) {
      const int jr = i / a.D, d = i % a.D;
      const size_t prow = (page * a.PS + jr) * a.KVH + h;
      const size_t sidx = prow * a.NB + d / a.BS;
      const uint8_t* krow = a.ke + prow * a.ED;
      const uint8_t* vrow = a.ve + prow * a.ED;
      float kv, vv;
      if (a.page_fmts != nullptr) {
        kv = mx::mixed_element_value(krow, d, pfs);
        vv = mx::mixed_element_value(vrow, d, pfs);
      } else if (pfs.bits == 8) {
        kv = mx::fp8_value(krow[d], pf);
        vv = mx::fp8_value(vrow[d], pf);
      } else {
        kv = mx::element_value(krow, d, pfs, pf);
        vv = mx::element_value(vrow, d, pfs, pf);
      }
      kt[jr * kstride + d] = mx::flush(kv * mx::e8m0_factor(a.ks[sidx]));
      vt[jr * kstride + d] = mx::flush(vv * mx::e8m0_factor(a.vs[sidx]));
    }
    __syncthreads();
    const int kpos = p * a.PS + j;
    for (int base = 0; base < rows; base += rows_per_pass) {
      const int row = base + warp * rpw + sub;
      const bool row_ok = row < rows;
      const int rr = row_ok ? row : 0;
      // padding queries (t >= n_new) clamp onto the last real position
      const int qpos = start + min(rr / a.G, n_new - 1);
      const bool keep = row_ok && j < a.PS && kpos <= qpos &&
                        (a.window <= 0 || kpos > qpos - a.window);
      float s = kNegInf;
      if (j < a.PS) {
        const __nv_bfloat16* qr = q_s + rr * qstride;
        const float* kr = kt + j * kstride;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        int d = 0;
        for (; d + 3 < a.D; d += 4) {
          s0 = fmaf(__bfloat162float(qr[d]), kr[d], s0);
          s1 = fmaf(__bfloat162float(qr[d + 1]), kr[d + 1], s1);
          s2 = fmaf(__bfloat162float(qr[d + 2]), kr[d + 2], s2);
          s3 = fmaf(__bfloat162float(qr[d + 3]), kr[d + 3], s3);
        }
        for (; d < a.D; ++d) s0 = fmaf(__bfloat162float(qr[d]), kr[d], s0);
        float sc = ((s0 + s1) + (s2 + s3)) * a.scale;
        if (a.softcap > 0.0f) sc = tanhf(sc / a.softcap) * a.softcap;
        if (keep) s = sc;
      }
      const float m_prev = m_s[rr];
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
        for (int key = 0; key < a.PS; ++key) {
          const float pk = __shfl_sync(kFull, pr, sub * lpr + key);
          pv = fmaf(pk, vt[key * kstride + d], pv);
        }
        if (row_ok) acc[rr * a.D + d] = acc[rr * a.D + d] * alpha + pv;
      }
      __syncwarp();
      if (row_ok && j == 0) {
        m_s[rr] = m_new;
        l_s[rr] = l_s[rr] * alpha + psum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  float* og = a.out + static_cast<size_t>(cell) * rows * a.D;
  for (int i = threadIdx.x; i < rows * a.D; i += blockDim.x) {
    og[i] = acc[i] / l_s[i / a.D];
  }
  if (threadIdx.x == 0) a.visits[cell] = max(0, valid - first);
}

}  // namespace

extern "C" size_t mx_attention_ragged_smem_bytes(int W, int G, int D, int PS) {
  const size_t rows = static_cast<size_t>(W) * G;
  return (2 * static_cast<size_t>(PS) * (D + 1) + 2 * rows + rows * D) *
             sizeof(float) +
         rows * (D + 2) * sizeof(__nv_bfloat16);
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
  int lpr = 1;
  while (lpr < PS) lpr <<= 1;
  const int bits = fmt < 2 ? 8 : (fmt < 4 ? 6 : 4);
  const bool ok_width = page_fmts != nullptr
                            ? ED == D && bits == 8
                            : ED * 8 == D * bits && bits != 6;
  if (PS > 32 || D % lpr != 0 || D % block_size != 0 || R * KVH == 0 ||
      !ok_width || (block_size * bits) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.ke = static_cast<uint8_t*>(ke);
  a.ks = static_cast<uint8_t*>(ks);
  a.ve = static_cast<uint8_t*>(ve);
  a.vs = static_cast<uint8_t*>(vs);
  a.table = static_cast<const int*>(table);
  a.row_start = static_cast<const int*>(row_start);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.page_fmts = static_cast<const int*>(page_fmts);
  a.out = static_cast<float*>(out);
  a.visits = static_cast<int*>(visits);
  a.R = R;
  a.KVH = KVH;
  a.W = W;
  a.G = G;
  a.D = D;
  a.ED = ED;
  a.PS = PS;
  a.P = P;
  a.BS = block_size;
  a.NB = D / block_size;
  a.fmt = fmt;
  a.window = window;
  a.mixed_mask = mixed_mask;
  a.mixed_default = mixed_default;
  a.lanes_per_row = lpr;
  a.softcap = softcap;
  a.scale = scale;
  const size_t smem = mx_attention_ragged_smem_bytes(W, G, D, PS);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_kernel<<<R * KVH, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
