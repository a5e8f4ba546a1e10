// The layer-fused megakernel: a whole L-layer ragged engine step in one
// persistent cooperative launch.
//
// Replaces the TPU kernel repro/kernels/mx_megakernel.py::mx_megakernel_step
// (kernel body _mx_megakernel, one pallas_call over the sequential grid
// (L, R, KVH, P)). Per layer l it computes exactly what the port's
// per-layer ragged step (nn/blocks.py::apply_ragged_step) does, with the
// same rounding points:
//   A1  RMSNorm of the residual (f32, rounded to bf16);
//   A2  the q, k and v products, each accumulated in f32 and rounded once
//       to bf16 (nn/linear.py::_dot_rounded);
//   B   per (row, kv-head) cell: RoPE of the cell's q and k from the
//       host-made f32 table (cos/sin rounded to bf16, then bf16 op by op,
//       as nn/rotary.py::apply_rope), then the ragged kernel's cell body
//       (mx_attention_ragged_cell.cuh: quantize-write of the window pages
//       into layer l's pool, the page walk), its f32 output merged over
//       heads and rounded to bf16;
//   C   the wo product (rounded to bf16) and the residual sum, kept in f32
//       for the FFN norm (XLA hands that norm the unrounded sum,
//       nn/blocks.py::_decode_tail);
//   D   RMSNorm of the f32 sum; the gate and up products, each rounded to
//       bf16; flush(g * flush(sigmoid(g))) rounded to bf16, times up,
//       rounded (nn/ffn.py);
//   E   the down product (rounded), added to the bf16-rounded sum: the new
//       bf16 residual.
// The final residual is the output; the final norm and the LM head stay
// outside, as in the reference.
//
// Design. The TPU kernel carries the residual in VMEM from one sequential
// grid step to the next; CTAs on Hopper run in no order, and a layer's
// products need the whole card (8 rows x 64 tokens, granite-8b's 4096 x
// 14336 FFN). So the grid is persistent -- one CTA per SM, as many as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows at the kernel's
// shared memory -- launched with cudaLaunchCooperativeKernel, and every
// phase is a grid-stride loop over its work followed by grid.sync(): every
// CTA passes every barrier, whether or not it had work (phase B has R * KVH
// cells, 64 at granite's shapes, for 132 CTAs). The residual, q/k/v, the
// attention output, the f32 residual sum and the FFN hidden live in global
// scratch tensors that the wrapper allocates; one dynamic shared-memory
// buffer serves every phase (the walk's, or the product tiles'). A cell
// writes pool pages of its own row only (the reference's window and
// trash-page rules), so no two cells race on a page.
//
// The products are the kernel's own tiles: 128 x 128 output tiles, walked
// 32 deep with nvcuda::wmma bf16 16x16x16 fragments (mma.sync) accumulating
// in f32, operands staged through a 3-stage cp.async ring; 16 warps each own
// a 32 x 32 sub-tile. Tiles are numbered M-fastest, so the CTAs that share
// a weight column block run together and read it once from L2. The gate
// and up tiles of one output block run back to back in one CTA, which keeps
// the rounded gate in shared memory for the activation.
//
// What bounds it on an H100 SXM (data-sheet peaks). Granite-8b at the main
// path's shapes (R 8, W 64: 512 rows) does 8.04 TFLOP of products a step:
// 8.13 ms at 989 TFLOP/s bf16, plus 36 walks of 7.94 us; streaming its
// 15.7 GB of bf16 weights takes 4.69 ms at 3.35 TB/s. This first version
// runs mma.sync from padded shared memory (no wgmma, no TMA) and the
// ragged kernel's scalar walk on 64 of the 132 SMs; chip_smoke.py times it
// beside that bound (PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "mx_attention_ragged_cell.cuh"
#include "mx_attention_walk.cuh"
#include "mx_codec.cuh"

namespace cg = cooperative_groups;
namespace wmma = nvcuda::wmma;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = mxwalk::kThreads;  // 512: the walk's CTA size
constexpr int kWarps = kThreads / 32;
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int AST = BK + 8;  // A tile row stride (bf16), 80 bytes
constexpr int BST = BN + 8;  // B tile row stride (bf16), 272 bytes
constexpr int CST = BN + 4;  // f32 accumulator tile row stride
constexpr size_t kStageBytes = (BM * AST + BK * BST) * sizeof(bf16);
constexpr size_t kAccOffset = STAGES * kStageBytes;
constexpr size_t kGateOffset = kAccOffset + BM * CST * sizeof(float);
constexpr size_t kGemmSmem = kGateOffset + BM * BN * sizeof(bf16);
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory
static_assert(BM * BK / 8 == kThreads && BK * BN / 8 == kThreads,
              "one 16-byte A chunk and one B chunk per thread and stage");
static_assert(kStageBytes % 128 == 0 && kAccOffset % 128 == 0 &&
                  kGateOffset % 128 == 0,
              "wmma pointers need 256-bit alignment");

__device__ __forceinline__ bf16 rnd(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32(float x) { return x; }

// ---------------------------------------------------------------------------
// products: C (M, N) = A (M, K) @ B (K, N), bf16 row-major, f32 accumulate
// ---------------------------------------------------------------------------

struct Gemm {
  const bf16* A;
  const bf16* B;
  int M, N, K;  // N and K multiples of 8 (16-byte rows of chunks)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bf16* stage_a(unsigned char* smem, int s) {
  return reinterpret_cast<bf16*>(smem + s * kStageBytes);
}
__device__ __forceinline__ bf16* stage_b(unsigned char* smem, int s) {
  return stage_a(smem, s) + BM * AST;
}

// one 16-byte chunk of A and one of B per thread; chunks past the matrix
// edge are zero-filled (a zero product adds nothing to the f32 sum)
__device__ __forceinline__ void load_stage(const Gemm& g, int m0, int n0,
                                           int k0, bf16* sa, bf16* sb) {
  const int t = threadIdx.x;
  {
    const int row = t >> 2, ch = t & 3;
    const int m = m0 + row, k = k0 + ch * 8;
    const bool ok = m < g.M && k < g.K;
    cp_async16(sa + row * AST + ch * 8,
               ok ? g.A + static_cast<size_t>(m) * g.K + k : g.A, ok);
  }
  {
    const int row = t >> 4, ch = t & 15;
    const int k = k0 + row, n = n0 + ch * 8;
    const bool ok = k < g.K && n < g.N;
    cp_async16(sb + row * BST + ch * 8,
               ok ? g.B + static_cast<size_t>(k) * g.N + n : g.B, ok);
  }
}

// The (tm, tn) output tile of g into the f32 accumulator tile in shared
// memory (row stride CST). Every thread of the CTA calls it; it returns
// after a __syncthreads, with the tile readable by every thread.
__device__ void gemm_tile(const Gemm& g, int tm, int tn,
                          unsigned char* smem) {
  const int m0 = tm * BM, n0 = tn * BN;
  const int nk = (g.K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);
  }
  __syncthreads();  // the previous tile's readers are done with the ring
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_stage(g, m0, n0, s * BK, stage_a(smem, s), stage_b(smem, s));
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage every warp finished reading in iteration kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      load_stage(g, m0, n0, nxt * BK, stage_a(smem, nxt % STAGES),
                 stage_b(smem, nxt % STAGES));
    }
    cp_async_commit();
    const bf16* sa = stage_a(smem, kt % STAGES);
    const bf16* sb = stage_b(smem, kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], sa + (wm * 32 + i * 16) * AST + kk,
                               AST);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], sb + kk * BST + wn * 32 + j * 16, BST);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  float* acc = reinterpret_cast<float*>(smem + kAccOffset);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(acc + (wm * 32 + i * 16) * CST + wn * 32 + j * 16,
                              c[i][j], CST, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int tiles_m(const Gemm& g) {
  return (g.M + BM - 1) / BM;
}
__device__ __forceinline__ int tiles_of(const Gemm& g) {
  return tiles_m(g) * ((g.N + BN - 1) / BN);
}

// Every tile of the jobs g[0..n), grid-stride over the CTAs, M-fastest;
// epi(job, m, n, acc) for each in-bounds output element.
template <int N, class Epi>
__device__ void gemm_phase(const Gemm (&g)[N], unsigned char* smem,
                           Epi epi) {
  int total = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) total += tiles_of(g[j]);
  const float* acc = reinterpret_cast<const float*>(smem + kAccOffset);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int job = 0, lt = t;
    while (lt >= tiles_of(g[job])) lt -= tiles_of(g[job++]);
    const Gemm& gj = g[job];
    const int tm = lt % tiles_m(gj), tn = lt / tiles_m(gj);
    gemm_tile(gj, tm, tn, smem);
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int m = tm * BM + i / BN, n = tn * BN + i % BN;
      if (m < gj.M && n < gj.N) epi(job, m, n, acc[(i / BN) * CST + i % BN]);
    }
  }
}

// ---------------------------------------------------------------------------
// row passes and RoPE
// ---------------------------------------------------------------------------

// out (M, DM) = bf16(x * rsqrt(mean(x^2) + eps) * (1 + scale)), one warp a
// row (nn/norms.py::rmsnorm_apply in f32)
template <class T>
__device__ void rmsnorm_rows(const T* x, const float* scale, bf16* out,
                             int M, int DM, float eps) {
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M;
       m += gridDim.x * kWarps) {
    const T* xr = x + static_cast<size_t>(m) * DM;
    float ss = 0.0f;
    for (int i = lane; i < DM; i += 32) {
      const float v = f32(xr[i]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    }
    const float inv = rsqrtf(ss / static_cast<float>(DM) + eps);
    bf16* orow = out + static_cast<size_t>(m) * DM;
    for (int i = lane; i < DM; i += 32) {
      orow[i] = rnd(__fmul_rn(__fmul_rn(f32(xr[i]), inv), 1.0f + scale[i]));
    }
  }
}

// rotate the pair (x1, x2) by the table's f32 cos/sin rounded to bf16, op
// by op in bf16 (nn/rotary.py::apply_rope)
__device__ __forceinline__ void rope_pair(bf16& x1, bf16& x2, float cosv,
                                          float sinv) {
  const float c = f32(rnd(cosv)), s = f32(rnd(sinv));
  const float a = f32(x1), b = f32(x2);
  const bf16 o1 = rnd(f32(rnd(a * c)) - f32(rnd(b * s)));
  const bf16 o2 = rnd(f32(rnd(b * c)) + f32(rnd(a * s)));
  x1 = o1;
  x2 = o2;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Args {
  const bf16* x0;  // (M, DM) the embedded tokens
  bf16* xout;      // (M, DM) the residual after each layer: the output
  const float* norm_mixer;  // (L, DM)
  const float* norm_ffn;    // (L, DM)
  const bf16 *wq, *wk, *wv, *wo, *wg, *wu, *wd;  // (L, K, N) each
  const float* rope_cos;  // (npos, D / 2)
  const float* rope_sin;
  bf16* h;       // (M, DM) normed residual (attention, then FFN)
  bf16* q;       // (M, HD) q before RoPE
  bf16* k;       // (M, KVD) k, RoPE'd in place by its cell
  bf16* v;       // (M, KVD)
  bf16* q_rot;   // (R, KVH, W * G, D) RoPE'd q, cell-major
  bf16* attn;    // (M, HD) attention output, heads merged
  float* x_sum;  // (M, DM) residual + attention, f32
  bf16* hidden;  // (M, DFF)
  int* visits;   // (L, R, KVH)
  size_t layer_elems, layer_scales;  // pool bytes of one layer
  mxcell::Cell cell;  // its pools are layer 0's
  int L, M, DM, HD, KVD, DFF, npos;
  float eps;
};

__global__ void __launch_bounds__(kThreads, 1) megakernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int W = a.cell.W, G = a.cell.G, D = a.cell.pools.D;
  const int KVH = a.cell.pools.KVH, cells = a.cell.R * KVH;
  const int half = D / 2, rows = W * G;
  const int M = a.M, DM = a.DM, HD = a.HD, KVD = a.KVD, DFF = a.DFF;
  for (int l = 0; l < a.L; ++l) {
    const bf16* x = l == 0 ? a.x0 : a.xout;
    // A1: pre-attention norm
    rmsnorm_rows(x, a.norm_mixer + static_cast<size_t>(l) * DM, a.h, M, DM,
                 a.eps);
    grid.sync();
    // A2: q, k, v
    {
      const Gemm g[3] = {
          {a.h, a.wq + static_cast<size_t>(l) * DM * HD, M, HD, DM},
          {a.h, a.wk + static_cast<size_t>(l) * DM * KVD, M, KVD, DM},
          {a.h, a.wv + static_cast<size_t>(l) * DM * KVD, M, KVD, DM}};
      bf16* const outs[3] = {a.q, a.k, a.v};
      gemm_phase(g, smem, [&](int job, int m, int n, float acc) {
        outs[job][static_cast<size_t>(m) * g[job].N + n] = rnd(acc);
      });
    }
    grid.sync();
    // B: RoPE and the ragged cell of layer l's pools
    {
      mxcell::Cell c = a.cell;
      c.pools.ke += l * a.layer_elems;
      c.pools.ve += l * a.layer_elems;
      c.pools.ks += l * a.layer_scales;
      c.pools.vs += l * a.layer_scales;
      for (int cell = blockIdx.x; cell < cells; cell += gridDim.x) {
        const int r = cell / KVH, hh = cell % KVH;
        const int start = c.row_start[r];
        bf16* qg = a.q_rot + static_cast<size_t>(cell) * rows * D;
        for (int i = threadIdx.x; i < (rows + W) * half; i += kThreads) {
          const int row = i / half, j = i % half;
          const int t = row < rows ? row / G : row - rows;
          const int pos = start + t;
          if (pos < 0 || pos >= a.npos) __trap();  // outside the table
          const size_t at = static_cast<size_t>(pos) * half + j;
          if (row < rows) {  // q: rotate into the cell's staging copy
            const bf16* src = a.q + static_cast<size_t>(r * W + t) * HD +
                              (hh * G + row % G) * D;
            bf16 x1 = src[j], x2 = src[j + half];
            rope_pair(x1, x2, a.rope_cos[at], a.rope_sin[at]);
            qg[row * D + j] = x1;
            qg[row * D + j + half] = x2;
          } else {  // k: rotate the cell's own rows in place
            bf16* p = a.k + static_cast<size_t>(r * W + t) * KVD + hh * D;
            bf16 x1 = p[j], x2 = p[j + half];
            rope_pair(x1, x2, a.rope_cos[at], a.rope_sin[at]);
            p[j] = x1;
            p[j + half] = x2;
          }
        }
        __syncthreads();  // the rotated rows, visible to the whole CTA
        const int visited = mxcell::ragged_cell(
            c, reinterpret_cast<float*>(smem), qg, cell,
            [&](int i, float val) {
              const int row = i / D, t = row / G;
              a.attn[static_cast<size_t>(r * W + t) * HD +
                     (hh * G + row % G) * D + i % D] = rnd(val);
            });
        if (threadIdx.x == 0) {
          a.visits[static_cast<size_t>(l) * cells + cell] = visited;
        }
        __syncthreads();  // shared memory is reused by the next cell
      }
    }
    grid.sync();
    // C: wo and the f32 residual sum
    {
      const Gemm g[1] = {
          {a.attn, a.wo + static_cast<size_t>(l) * HD * DM, M, DM, HD}};
      gemm_phase(g, smem, [&](int, int m, int n, float acc) {
        const size_t i = static_cast<size_t>(m) * DM + n;
        a.x_sum[i] = f32(x[i]) + f32(rnd(acc));
      });
    }
    grid.sync();
    // D1: FFN norm of the unrounded sum
    rmsnorm_rows(a.x_sum, a.norm_ffn + static_cast<size_t>(l) * DM, a.h, M,
                 DM, a.eps);
    grid.sync();
    // D2: gate and up tiles of one output block back to back, then the
    // activation from the gate kept in shared memory
    {
      const Gemm gate = {a.h, a.wg + static_cast<size_t>(l) * DM * DFF, M,
                         DFF, DM};
      const Gemm up = {a.h, a.wu + static_cast<size_t>(l) * DM * DFF, M,
                       DFF, DM};
      const float* acc = reinterpret_cast<const float*>(smem + kAccOffset);
      bf16* gs = reinterpret_cast<bf16*>(smem + kGateOffset);
      for (int t = blockIdx.x; t < tiles_of(gate); t += gridDim.x) {
        const int tm = t % tiles_m(gate), tn = t / tiles_m(gate);
        gemm_tile(gate, tm, tn, smem);
        for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
          gs[i] = rnd(acc[(i / BN) * CST + i % BN]);
        }
        gemm_tile(up, tm, tn, smem);
        for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
          const int m = tm * BM + i / BN, n = tn * BN + i % BN;
          if (m >= M || n >= DFF) continue;
          const float gv = f32(gs[i]);
          const float act = mx::flush(
              gv * mx::flush(1.0f / (1.0f + expf(-gv))));
          const float u = f32(rnd(acc[(i / BN) * CST + i % BN]));
          a.hidden[static_cast<size_t>(m) * DFF + n] = rnd(f32(rnd(act)) * u);
        }
      }
    }
    grid.sync();
    // E: down and the new residual
    {
      const Gemm g[1] = {
          {a.hidden, a.wd + static_cast<size_t>(l) * DFF * DM, M, DM, DFF}};
      gemm_phase(g, smem, [&](int, int m, int n, float acc) {
        const size_t i = static_cast<size_t>(m) * DM + n;
        a.xout[i] = rnd(f32(rnd(a.x_sum[i])) + f32(rnd(acc)));
      });
    }
    grid.sync();
  }
}

size_t smem_for(int W, int G, int D, int PS) {
  const size_t walk = mxwalk::smem_bytes(W * G, D, PS);
  return walk > kGemmSmem ? walk : kGemmSmem;
}

}  // namespace

extern "C" size_t mx_megakernel_smem_bytes(int W, int G, int D, int PS) {
  return smem_for(W, G, D, PS);
}

// CTAs of the persistent grid at this shared memory (CTAs per SM that fit,
// times the SMs), or the negated cudaError_t when the query fails.
extern "C" int mx_megakernel_grid(int W, int G, int D, int PS) {
  const size_t smem = smem_for(W, G, D, PS);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, megakernel, kThreads, smem)) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sms;
}

// Launch the whole step on `stream`; returns the cudaError_t (0 = success).
// Weights are (L, K, N) bf16 stacks, pools (L, NP, PS, KVH, ED / NB) with
// the ragged kernel's geometry; table / row_start / seq_lens are already
// normalised (entries in [0, NP), lengths clamped). No fallback: a grid
// that cannot be co-resident, or any launch error, is returned.
extern "C" int mx_megakernel_launch(
    const void* x0, void* xout, const void* norm_mixer, const void* norm_ffn,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* wg, const void* wu, const void* wd, void* ke, void* ks,
    void* ve, void* vs, const void* table, const void* row_start,
    const void* seq_lens, const void* page_fmts, const void* rope_cos,
    const void* rope_sin, void* h, void* q, void* k, void* v, void* q_rot,
    void* attn, void* x_sum, void* hidden, void* visits, int L, int R,
    int W, int H, int KVH, int D, int DM, int DFF, int NP, int PS, int ED,
    int P, int npos, int block_size, int fmt, int window, int mixed_mask,
    int mixed_default, float eps, float softcap, float scale,
    void* stream) {
  const int M = R * W;
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      R * KVH == 0 || L < 1 || H % KVH || D % 2 || DM % 8 || DFF % 8 ||
      (H * D) % 8 || (KVH * D) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = mx_megakernel_grid(W, H / KVH, D, PS);
  if (grid <= 0) return -grid;
  Args a;
  a.x0 = static_cast<const bf16*>(x0);
  a.xout = static_cast<bf16*>(xout);
  a.norm_mixer = static_cast<const float*>(norm_mixer);
  a.norm_ffn = static_cast<const float*>(norm_ffn);
  a.wq = static_cast<const bf16*>(wq);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.wo = static_cast<const bf16*>(wo);
  a.wg = static_cast<const bf16*>(wg);
  a.wu = static_cast<const bf16*>(wu);
  a.wd = static_cast<const bf16*>(wd);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.h = static_cast<bf16*>(h);
  a.q = static_cast<bf16*>(q);
  a.k = static_cast<bf16*>(k);
  a.v = static_cast<bf16*>(v);
  a.q_rot = static_cast<bf16*>(q_rot);
  a.attn = static_cast<bf16*>(attn);
  a.x_sum = static_cast<float*>(x_sum);
  a.hidden = static_cast<bf16*>(hidden);
  a.visits = static_cast<int*>(visits);
  const size_t rows = static_cast<size_t>(NP) * PS * KVH;
  a.layer_elems = rows * ED;
  a.layer_scales = rows * (D / block_size);
  mxcell::Cell& c = a.cell;
  c.k_new = a.k;
  c.v_new = a.v;
  c.pools = mxwalk::make_pools(ke, ks, ve, vs, page_fmts, KVH, D, ED, PS,
                               block_size, fmt, mixed_mask, mixed_default);
  c.table = static_cast<const int*>(table);
  c.row_start = static_cast<const int*>(row_start);
  c.seq_lens = static_cast<const int*>(seq_lens);
  c.R = R;
  c.W = W;
  c.G = H / KVH;
  c.P = P;
  c.window = window;
  c.softcap = softcap;
  c.scale = scale;
  a.L = L;
  a.M = M;
  a.DM = DM;
  a.HD = H * D;
  a.KVD = KVH * D;
  a.DFF = DFF;
  a.npos = npos;
  a.eps = eps;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(megakernel), dim3(grid), dim3(kThreads),
      params, smem_for(W, H / KVH, D, PS), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
