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
//       into layer l's pool, then the tensor-core page walk of the cell's
//       queries in tiles of T tokens), its f32 output merged over heads and
//       rounded to bf16;
//   C   the wo product (rounded to bf16) and the residual sum, kept in f32
//       for the FFN norm (XLA hands that norm the unrounded sum,
//       nn/blocks.py::_decode_tail);
//   D   RMSNorm of the f32 sum, then the FFN of the reference's kind
//       (nn/ffn.py): swiglu and geglu take the gate and up products, each
//       rounded to bf16, then act(gate) rounded to bf16 times up, rounded
//       (act flush(g * flush(sigmoid(g))) or the tanh GELU); gelu has no
//       gate and takes the tanh GELU of the rounded up product, rounded.
//       The tanh GELU is the plain version's formula on CUDA tensors op by
//       op (flushed input, tanhf, no contraction, flushed result);
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
// buffer serves every phase (the walk's, or the product ring): the walk's
// part holds one query tile of a cell (T tokens, the host's choice,
// mx_megakernel.py), so a step of several prompt chunks a row (W 256,
// 1,024 query rows a cell at granite's shapes) fits beside the ring. A cell
// writes pool pages of its own row only (the reference's window and
// trash-page rules), so no two cells race on a page.
//
// The products run on wgmma from a TMA ring. An output tile is 128 weight
// columns by 256 or 128 activation rows (the host plan's choice per phase,
// mx_megakernel.megakernel_plan: the larger tile where its count fills the
// card, else the smaller one -- wo and down at granite's shapes). Its four
// warpgroups each own 64 columns by half the rows (m64nNk16: the weight
// tile is wgmma's A operand, read MN-major from the (L, K, N) stack as
// stored, the activation rows its K-major B operand). One thread asks TMA
// for each 64-deep stage -- two 64-column boxes of one tensor map per
// weight stack (3-D over N, K and the layer) and one box of the phase's
// activation -- into a 4-stage ring of 128-byte-swizzled tiles, one
// mbarrier a stage, keeping three stages ahead of the products across
// tiles; edges past M, N or K arrive zero-filled. Each tile sums its whole
// contraction in order in the tensor cores' f32 accumulators, as the
// per-layer step's cuBLAS products do (a split contraction summed in
// another order moved more pool codes off the plain version than the
// two-layer gate allows, PERF.md); the sums stay in registers, and every
// epilogue reads them there and rounds where the per-layer step rounds.
// A gate/up
// tile takes 64 columns of each: the even warpgroups sum the gate, the odd
// ones the up projection of the same elements, and the rounded gate
// crosses to its up thread through shared memory. Without a gate (gelu)
// that phase is up's product alone, in plain 128-column tiles. Tiles are
// numbered with the activation tile fastest, so the CTAs that share a
// weight column block run together and read it once from L2.
//
// What bounds it on an H100 SXM (data-sheet peaks). Granite-8b at the main
// path's shapes (R 8, W 64: 512 rows) does 8.04 TFLOP of products a step:
// 8.13 ms at 989 TFLOP/s bf16, plus 36 walks; streaming its 15.7 GB of
// bf16 weights takes 4.69 ms at 3.35 TB/s. A 128 x 256 tile moves 48 KB
// from L2 a 64-deep stage for 4.2 MFLOP, so the products are held by L2
// bandwidth and the tile count's waves; the walk runs on R * KVH = 64 of
// the 132 SMs. chip_smoke.py times the step beside the bound and
// tools/profile_mx_megakernel.py splits it by phase (PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"
#include "mx_attention_ragged_cell.cuh"
#include "mx_attention_walk.cuh"
#include "mx_codec.cuh"

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int kThreads = mxwalk::kThreads;  // 512: the walk's CTA size
constexpr int kWarps = kThreads / 32;
// a product tile: TN weight columns (a gate/up pair: 64 of each) by 256 or
// 128 activation rows (the plan's), TK-deep stages
constexpr int TN = 128, TK = 64, STAGES = 4;
constexpr int kHalf = TK * 128;               // one 64-column weight box
constexpr int kStage = 2 * kHalf + 256 * 128;  // 48 KB: the 256-row tile's
constexpr int kHead = 1024;  // the stages' mbarriers
constexpr int kRing = STAGES * kStage;
constexpr int kXch = 32 * 256 * 4;  // a 256-row pair tile's gate, bf16 pairs
constexpr int kGemmSmem = kRing + kXch;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory
static_assert(kStage % 1024 == 0 && kHalf % 1024 == 0,
              "128-byte-swizzled boxes start on 1024-byte lines");

// the FFN kinds (mx_megakernel.FFN_KINDS)
constexpr int kSwiglu = 0, kGeglu = 1, kGelu = 2;

__device__ __forceinline__ bf16 rnd(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32(float x) { return x; }

// ---------------------------------------------------------------------------
// products: out (M, N) = A (M, K) @ W[l] (K, N), bf16, f32 sums
// ---------------------------------------------------------------------------

// the tensor maps: each phase's activation (2-D over K and M, boxes of the
// phase's tile rows) and the weight stacks (3-D over N, K and L)
struct Maps {
  CUtensorMap a_qkv, a_wo, a_gu, a_down;
  CUtensorMap wq, wk, wv, wo, wg, wu, wd;
};

// One product of a phase. A plain job's tile is TN output columns, two
// 64-column boxes of w. A pair (gate/up) tile is 64 output columns: box 0
// from w (gate), box 1 the same columns of w2 (up), so the two sums of an
// element meet in one CTA.
struct Job {
  const CUtensorMap* a;
  const CUtensorMap* w;
  const CUtensorMap* w2;
  int N, K, pair;
};

struct Phase {
  Job job[3];
  int njobs, M;
};

__device__ __forceinline__ int tile_cols(const Job& j) {
  return j.pair ? 64 : TN;
}

__device__ __forceinline__ int tiles_n(const Job& j) {
  return (j.N + tile_cols(j) - 1) / tile_cols(j);
}

// Unit u of a phase (mx_megakernel.plan_units is its mirror): the jobs'
// tiles one job after the other, within a job the activation tile fastest,
// so the CTAs that share a weight column block run together.
struct Unit {
  int job, tile_m, tile_n;
};

__device__ inline Unit unit_of(const Phase& ph, int tm, int u) {
  Unit x;
  x.job = 0;
  for (;;) {
    const int n = tm * tiles_n(ph.job[x.job]);
    if (u < n || x.job == ph.njobs - 1) break;
    u -= n;
    ++x.job;
  }
  x.tile_m = u % tm;
  x.tile_n = u / tm;
  return x;
}

// one stage (k-th 64-deep slice of unit u's contraction) into ring slot
// `slot` (thread 0 only)
template <int R>
__device__ __forceinline__ void issue_stage(const Phase& ph, int tm, int u,
                                            int k, int layer, uint8_t* ring,
                                            uint64_t* bars, int slot) {
  const Unit x = unit_of(ph, tm, u);
  const Job& j = ph.job[x.job];
  uint8_t* st = ring + slot * kStage;
  uint64_t* bar = bars + slot;
  const int n0 = x.tile_n * tile_cols(j), k0 = k * TK;
  mbar_expect(bar, 2 * kHalf + R * 128);
  tma_load_3d(st, j.w, n0, k0, layer, bar);
  tma_load_3d(st + kHalf, j.pair ? j.w2 : j.w, j.pair ? n0 : n0 + 64, k0,
              layer, bar);
  tma_load(st + 2 * kHalf, j.a, k0, x.tile_m * R, bar);
}

// Every tile of a phase at R activation rows a tile (256 or 128, the
// plan's), grid-stride over the CTAs: the CTA's stages stream through the
// ring, thread 0 keeping STAGES - 1 ahead of the products across tiles.
// `used` counts the stages this CTA has consumed since launch (the ring's
// slot and phase parity). epi(x, acc, m0, n0) runs on each finished tile
// with the f32 sums in registers, in wgmma's layout: acc[4j + 2h + e] is
// output row m0 + (R / 2)(wg / 2) + 2 (lane % 4) + 8j + e, column
// n0 + 16 (warp % 4) + lane / 4 + 8h, plus 64 (wg % 2) for a plain job
// (a pair's odd warpgroups hold up, the even ones gate).
template <int R, class Epi>
__device__ void gemm_phase(const Phase& ph, int layer, uint8_t* smem,
                           int& used, Epi epi) {
  constexpr int kAcc = R / 4;  // 64 columns x R / 2 rows / 128 threads
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kHead;
  const int tm = (ph.M + R - 1) / R;
  int units = 0;
  for (int j = 0; j < ph.njobs; ++j) units += tm * tiles_n(ph.job[j]);
  const int nk0 = (ph.job[0].K + TK - 1) / TK;  // the jobs share K
  const int wg = threadIdx.x / 128;
  // the previous phase's generic shared-memory writes before TMA's
  fence_proxy_async();
  __syncthreads();
  // the producer's place: unit pu (grid-stride), stage pk of it
  int pu = blockIdx.x, pk = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES - 1 && pu < units; ++i) {
      issue_stage<R>(ph, tm, pu, pk, layer, ring, bars, (used + i) % STAGES);
      if (++pk == nk0) pk = 0, pu += gridDim.x;
    }
  }
  int issued = used + STAGES - 1;  // the stage the next issue fills
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    for (int k = 0; k < nk0; ++k) {
      const int slot = used % STAGES;
      mbar_wait(bars + slot, (used / STAGES) & 1);
      const uint8_t* st = ring + slot * kStage;
      const uint64_t dw = sw128_desc_mn(st + (wg & 1) * kHalf);
      const uint64_t da = sw128_desc(st + 2 * kHalf + (wg >> 1) * (R / 2) * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16<R / 2, 1>(acc, dw + 128 * kk, da + 2 * kk,
                             k == 0 && kk == 0 ? 0 : 1);
      }
      wgmma_commit();
      // the previous stage's products are done in every warpgroup: its
      // slot takes the stage STAGES - 1 ahead
      wgmma_wait<1>();
      __syncthreads();
      if (threadIdx.x == 0 && pu < units) {
        issue_stage<R>(ph, tm, pu, pk, layer, ring, bars, issued % STAGES);
        if (++pk == nk0) pk = 0, pu += gridDim.x;
      }
      ++issued;
      ++used;
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    const Unit x = unit_of(ph, tm, u);
    epi(x, acc, x.tile_m * R, x.tile_n * tile_cols(ph.job[x.job]));
  }
}

// the fragment element i of this thread at R tile rows: output row and
// column offsets in the tile (a plain job's column; a pair's adds no 64)
template <int R>
__device__ __forceinline__ int frag_m(int i) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128, lane = t % 32;
  return (R / 2) * (wg >> 1) + 2 * (lane % 4) + 8 * (i >> 2) + (i & 1);
}
__device__ __forceinline__ int frag_n(int i, bool pair) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128, lane = t % 32;
  return (pair ? 0 : 64 * (wg & 1)) + 16 * (t / 32) + lane / 4 +
         8 * ((i >> 1) & 1);
}

// a phase at the plan's tile rows (256 or 128)
template <class Epi>
__device__ __forceinline__ void run_phase(const Phase& ph, int rows,
                                          int layer, uint8_t* smem,
                                          int& used, Epi epi) {
  if (rows == 256) {
    gemm_phase<256>(ph, layer, smem, used, [&](const Unit& x,
                                               const float* acc, int m0,
                                               int n0) {
      epi(std::integral_constant<int, 256>(), x, acc, m0, n0);
    });
  } else {
    gemm_phase<128>(ph, layer, smem, used, [&](const Unit& x,
                                               const float* acc, int m0,
                                               int n0) {
      epi(std::integral_constant<int, 128>(), x, acc, m0, n0);
    });
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
  constexpr int kBatch = 32;  // loads a lane has in flight
  const int lane = threadIdx.x & 31;
  // row m on CTA m % grid: the rows spread over every SM
  for (int m = blockIdx.x + gridDim.x * (threadIdx.x >> 5); m < M;
       m += gridDim.x * kWarps) {
    const T* xr = x + static_cast<size_t>(m) * DM;
    // each lane sums elements lane, lane + 32, ... in order; a batch's
    // loads are issued before its sums
    float ss = 0.0f;
    for (int base = lane; base < DM; base += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + 32 * k;
        v[k] = i < DM ? f32(xr[i]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (base + 32 * k < DM) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    }
    const float inv = rsqrtf(ss / static_cast<float>(DM) + eps);
    bf16* orow = out + static_cast<size_t>(m) * DM;
    for (int base = lane; base < DM; base += 32 * kBatch) {
      float v[kBatch], sc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + 32 * k;
        v[k] = i < DM ? f32(xr[i]) : 0.0f;
        sc[k] = i < DM ? scale[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + 32 * k;
        if (i < DM) {
          orow[i] = rnd(__fmul_rn(__fmul_rn(v[k], inv), 1.0f + sc[k]));
        }
      }
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

// jax.nn.gelu(g, approximate=True) as the plain version computes it on CUDA
// tensors (nn/ffn.py::gelu_tanh): u = (g + g * g * g * 0.044715) *
// 0.7978845834732056, then g * ((tanh(u) + 1) * 0.5), each op rounded to
// f32 (no contraction), subnormal input and result flushed
__device__ __forceinline__ float gelu_tanh(float g) {
  g = mx::flush(g);
  const float g3 = __fmul_rn(__fmul_rn(g, g), g);
  const float u = __fmul_rn(__fadd_rn(g, __fmul_rn(g3, 0.044715f)),
                            0.7978845834732056f);
  return mx::flush(__fmul_rn(g, __fmul_rn(__fadd_rn(tanhf(u), 1.0f), 0.5f)));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Args {
  const bf16* x0;  // (M, DM) the embedded tokens
  bf16* xout;      // (M, DM) the residual after each layer: the output
  const float* norm_mixer;  // (L, DM)
  const float* norm_ffn;    // (L, DM)
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
  int rows_qkv, rows_wo, rows_gu, rows_down;  // the plan's tile rows
  int ffn_kind;  // kSwiglu, kGeglu or kGelu
  size_t layer_elems, layer_scales;  // pool bytes of one layer
  mxcell::Cell cell;  // its pools are layer 0's
  int L, M, DM, HD, KVD, DFF, npos;
  float eps;
};

__global__ void __launch_bounds__(kThreads, 1)
    megakernel(const Args a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::grid_group grid = cg::this_grid();
  const int W = a.cell.W, G = a.cell.G, D = a.cell.pools.D;
  const int KVH = a.cell.pools.KVH, cells = a.cell.R * KVH;
  const int half = D / 2, rows = W * G;
  const int M = a.M, DM = a.DM, HD = a.HD, KVD = a.KVD, DFF = a.DFF;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int used = 0;  // ring stages consumed: slot used % STAGES, its parity
  const Phase qkv = {{{&maps.a_qkv, &maps.wq, &maps.wq, HD, DM, 0},
                      {&maps.a_qkv, &maps.wk, &maps.wk, KVD, DM, 0},
                      {&maps.a_qkv, &maps.wv, &maps.wv, KVD, DM, 0}},
                     3, M};
  const Phase out_proj = {{{&maps.a_wo, &maps.wo, &maps.wo, DM, HD, 0}}, 1,
                          M};
  const Phase gate_up = {{{&maps.a_gu, &maps.wg, &maps.wu, DFF, DM, 1}}, 1,
                         M};
  // the gelu kind's up product alone (no gate)
  const Phase up_only = {{{&maps.a_gu, &maps.wu, &maps.wu, DFF, DM, 0}}, 1,
                         M};
  const Phase down = {{{&maps.a_down, &maps.wd, &maps.wd, DM, DFF, 0}}, 1,
                      M};
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + kHead + kRing);
  // Every phase's writers fence the async proxy before the grid-wide
  // barrier: the next phase's TMA loads read what they wrote.
  for (int l = 0; l < a.L; ++l) {
    const bf16* x = l == 0 ? a.x0 : a.xout;
    // A1: pre-attention norm
    rmsnorm_rows(x, a.norm_mixer + static_cast<size_t>(l) * DM, a.h, M, DM,
                 a.eps);
    fence_proxy_async_global();
    grid.sync();
    // A2: q, k, v
    {
      bf16* const outs[3] = {a.q, a.k, a.v};
      run_phase(qkv, a.rows_qkv, l, smem, used,
                [&](auto rt, const Unit& u, const float* acc, int m0,
                    int n0) {
                  constexpr int R = decltype(rt)::value;
                  const int N = qkv.job[u.job].N;
                  bf16* o = outs[u.job];
#pragma unroll
                  for (int i = 0; i < R / 4; ++i) {
                    const int m = m0 + frag_m<R>(i), n = n0 + frag_n(i, false);
                    if (m < M && n < N) {
                      o[static_cast<size_t>(m) * N + n] = rnd(acc[i]);
                    }
                  }
                });
    }
    fence_proxy_async_global();
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
        // pair i of the q rows (rotated into the cell's staging copy), then
        // of the cell's own k rows (rotated in place); a thread loads four
        // pairs before it rotates and stores them
        const int pairs = (rows + W) * half;
        for (int i0 = threadIdx.x; i0 < pairs; i0 += 4 * kThreads) {
          bf16 x1[4], x2[4];
          float cs[4], sn[4];
          bf16* dst[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            if (i >= pairs) continue;
            const int row = i / half, j = i % half;
            const int t = row < rows ? row / G : row - rows;
            const int pos = start + t;
            if (pos < 0 || pos >= a.npos) __trap();  // outside the table
            const size_t at = static_cast<size_t>(pos) * half + j;
            const bf16* src =
                row < rows ? a.q + static_cast<size_t>(r * W + t) * HD +
                                 (hh * G + row % G) * D + j
                           : a.k + static_cast<size_t>(r * W + t) * KVD +
                                 hh * D + j;
            dst[u] = row < rows ? qg + row * D + j : const_cast<bf16*>(src);
            x1[u] = src[0];
            x2[u] = src[half];
            cs[u] = __ldg(a.rope_cos + at);
            sn[u] = __ldg(a.rope_sin + at);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i0 + u * kThreads >= pairs) continue;
            rope_pair(x1[u], x2[u], cs[u], sn[u]);
            dst[u][0] = x1[u];
            dst[u][half] = x2[u];
          }
        }
        __syncthreads();  // the rotated rows, visible to the whole CTA
        const int visited = mxcell::ragged_cell(
            c, smem + kHead, qg, cell, [&](int i, float4 val) {
              const int row = i / D, t = row / G;
              const __nv_bfloat162 lo = __floats2bfloat162_rn(val.x, val.y);
              const __nv_bfloat162 hi = __floats2bfloat162_rn(val.z, val.w);
              uint2 u;
              u.x = *reinterpret_cast<const uint32_t*>(&lo);
              u.y = *reinterpret_cast<const uint32_t*>(&hi);
              *reinterpret_cast<uint2*>(
                  a.attn + static_cast<size_t>(r * W + t) * HD +
                  (hh * G + row % G) * D + i % D) = u;
            });
        if (threadIdx.x == 0) {
          a.visits[static_cast<size_t>(l) * cells + cell] = visited;
        }
        __syncthreads();  // shared memory is reused by the next cell
      }
    }
    fence_proxy_async_global();
    grid.sync();
    // C: wo and the f32 residual sum
    run_phase(out_proj, a.rows_wo, l, smem, used,
              [&](auto rt, const Unit&, const float* acc, int m0, int n0) {
                constexpr int R = decltype(rt)::value;
#pragma unroll
                for (int i = 0; i < R / 4; ++i) {
                  const int m = m0 + frag_m<R>(i), n = n0 + frag_n(i, false);
                  if (m < M && n < DM) {
                    const size_t e = static_cast<size_t>(m) * DM + n;
                    a.x_sum[e] = f32(x[e]) + f32(rnd(acc[i]));
                  }
                }
              });
    fence_proxy_async_global();
    grid.sync();
    // D1: FFN norm of the unrounded sum
    rmsnorm_rows(a.x_sum, a.norm_ffn + static_cast<size_t>(l) * DM, a.h, M,
                 DM, a.eps);
    fence_proxy_async_global();
    grid.sync();
    // D2: gate (even warpgroups) and up (odd ones) of the same columns; the
    // rounded gate crosses to its up thread through shared memory. Without
    // a gate (gelu), each thread's up sums go through the GELU where they
    // are.
    if (a.ffn_kind == kGelu) {
      run_phase(up_only, a.rows_gu, l, smem, used,
                [&](auto rt, const Unit&, const float* acc, int m0, int n0) {
                  constexpr int R = decltype(rt)::value;
#pragma unroll
                  for (int i = 0; i < R / 4; ++i) {
                    const int m = m0 + frag_m<R>(i), n = n0 + frag_n(i, false);
                    if (m < M && n < DFF) {
                      a.hidden[static_cast<size_t>(m) * DFF + n] =
                          rnd(gelu_tanh(f32(rnd(acc[i]))));
                    }
                  }
                });
    } else {
      run_phase(gate_up, a.rows_gu, l, smem, used,
                [&](auto rt, const Unit&, const float* acc, int m0, int n0) {
                  constexpr int R = decltype(rt)::value;
                  const bool is_up = (threadIdx.x / 128) & 1;
                  uint32_t* xs = xch + (threadIdx.x / 256) * 128 +
                                 threadIdx.x % 128;
                  if (!is_up) {
#pragma unroll
                    for (int i = 0; i < R / 4; i += 2) {
                      const __nv_bfloat162 g2 =
                          __floats2bfloat162_rn(acc[i], acc[i + 1]);
                      xs[(i / 2) * 256] =
                          *reinterpret_cast<const uint32_t*>(&g2);
                    }
                  }
                  __syncthreads();
                  if (is_up) {
#pragma unroll
                    for (int i = 0; i < R / 4; ++i) {
                      const int m = m0 + frag_m<R>(i), n = n0 + frag_n(i, true);
                      if (m >= M || n >= DFF) continue;
                      const uint32_t g2 = xs[(i / 2) * 256];
                      const float gv = __uint_as_float(
                          (i & 1) ? (g2 & 0xFFFF0000u) : (g2 << 16));
                      const float act =
                          a.ffn_kind == kGeglu
                              ? gelu_tanh(gv)
                              : mx::flush(gv *
                                          mx::flush(1.0f / (1.0f + expf(-gv))));
                      const float u = f32(rnd(acc[i]));
                      a.hidden[static_cast<size_t>(m) * DFF + n] =
                          rnd(f32(rnd(act)) * u);
                    }
                  }
                });
    }
    fence_proxy_async_global();
    grid.sync();
    // E: down and the new residual
    run_phase(down, a.rows_down, l, smem, used,
              [&](auto rt, const Unit&, const float* acc, int m0, int n0) {
                constexpr int R = decltype(rt)::value;
#pragma unroll
                for (int i = 0; i < R / 4; ++i) {
                  const int m = m0 + frag_m<R>(i), n = n0 + frag_n(i, false);
                  if (m < M && n < DM) {
                    const size_t e = static_cast<size_t>(m) * DM + n;
                    a.xout[e] = rnd(f32(rnd(a.x_sum[e])) + f32(rnd(acc[i])));
                  }
                }
              });
    fence_proxy_async_global();
    grid.sync();
  }
}

// bytes of dynamic shared memory: 1024-byte alignment slack, the stages'
// mbarriers, then the walk's state for a query tile of T tokens or the
// product ring and gate exchange
size_t smem_for(int T, int G, int D, int PS) {
  const size_t walk = mxwalk::smem_bytes(T * G, D, PS);
  const size_t gemm = static_cast<size_t>(kGemmSmem);
  return 1024 + kHead + (walk > gemm ? walk : gemm);
}

// a 128-byte-swizzled bf16 tensor map over `rank` dims (innermost first,
// byte strides of the outer ones), read in boxes of 64 x box1 (x 1)
bool bf16_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, int box1) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an (M, K) activation, boxes of `rows` rows
bool act_map(CUtensorMap* map, const void* base, int M, int K, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  return bf16_map(map, base, 2, dims, strides, rows);
}

// an (L, K, N) weight stack, 64 x 64 boxes of one layer
bool weight_map(CUtensorMap* map, const void* base, int L, int K, int N) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(N) * K * 2};
  return bf16_map(map, base, 3, dims, strides, TK);
}

}  // namespace

extern "C" size_t mx_megakernel_smem_bytes(int T, int G, int D, int PS) {
  return smem_for(T, G, D, PS);
}

// CTAs of the persistent grid at the shared memory of query tiles of T
// tokens (CTAs per SM that fit, times the SMs), or the negated cudaError_t
// when the query fails.
extern "C" int mx_megakernel_grid(int T, int G, int D, int PS) {
  const size_t smem = smem_for(T, G, D, PS);
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
// normalised (entries in [0, NP), lengths clamped). A cell's queries are
// walked in tiles of T tokens (T >= W: one tile). `grid` (for this T) and
// each phase's tile rows (256 or 128) are mx_megakernel.megakernel_plan's. No
// fallback: a shape the products or the walk cannot take, a grid that
// cannot be co-resident, or any launch error, is returned. ffn_kind is
// kSwiglu, kGeglu or kGelu; for kGelu `wg` is not read (pass `wu`).
extern "C" int mx_megakernel_launch(
    const void* x0, void* xout, const void* norm_mixer, const void* norm_ffn,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* wg, const void* wu, const void* wd, void* ke, void* ks,
    void* ve, void* vs, const void* table, const void* row_start,
    const void* seq_lens, const void* page_fmts, const void* rope_cos,
    const void* rope_sin, void* h, void* q, void* k, void* v, void* q_rot,
    void* attn, void* x_sum, void* hidden, void* visits, int L, int R,
    int W, int H, int KVH, int D, int DM, int DFF, int NP, int PS, int ED,
    int P, int npos, int T, int block_size, int fmt, int window,
    int mixed_mask, int mixed_default, int grid, int ffn_kind, int rows_qkv,
    int rows_wo, int rows_gu, int rows_down, float eps, float softcap,
    float scale, void* stream) {
  const int M = R * W;
  auto rows_ok = [](int r) { return r == 256 || r == 128; };
  if (!mxwalk::pools_ok(page_fmts, D, ED, PS, block_size, fmt) ||
      R * KVH == 0 || L < 1 || T < 1 || H % KVH || D % 2 || DM % 8 ||
      DFF % 8 || (H * D) % 8 || (KVH * D) % 8 || !rows_ok(rows_qkv) ||
      !rows_ok(rows_wo) || !rows_ok(rows_gu) || !rows_ok(rows_down) ||
      ffn_kind < kSwiglu || ffn_kind > kGelu) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T = T < W ? T : W;
  const int fit = mx_megakernel_grid(T, H / KVH, D, PS);
  if (fit <= 0) return -fit;
  if (grid < 1 || grid > fit) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x0 = static_cast<const bf16*>(x0);
  a.xout = static_cast<bf16*>(xout);
  a.norm_mixer = static_cast<const float*>(norm_mixer);
  a.norm_ffn = static_cast<const float*>(norm_ffn);
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
  a.rows_qkv = rows_qkv;
  a.rows_wo = rows_wo;
  a.rows_gu = rows_gu;
  a.rows_down = rows_down;
  a.ffn_kind = ffn_kind;
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
  c.NP = NP;
  c.window = window;
  c.T = T;
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
  Maps maps;
  const int HD = H * D, KVD = KVH * D;
  if (!act_map(&maps.a_qkv, h, M, DM, rows_qkv) ||
      !act_map(&maps.a_wo, attn, M, HD, rows_wo) ||
      !act_map(&maps.a_gu, h, M, DM, rows_gu) ||
      !act_map(&maps.a_down, hidden, M, DFF, rows_down) ||
      !weight_map(&maps.wq, wq, L, DM, HD) ||
      !weight_map(&maps.wk, wk, L, DM, KVD) ||
      !weight_map(&maps.wv, wv, L, DM, KVD) ||
      !weight_map(&maps.wo, wo, L, HD, DM) ||
      !weight_map(&maps.wg, wg, L, DM, DFF) ||
      !weight_map(&maps.wu, wu, L, DM, DFF) ||
      !weight_map(&maps.wd, wd, L, DFF, DM)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  void* params[] = {&a, &maps};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(megakernel), dim3(grid), dim3(kThreads),
      params, smem_for(T, H / KVH, D, PS), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
