// MX matrix products, the paper's VMXDOTP analogue.
//
// Replace the TPU kernels of repro/kernels/mx_matmul.py:
//   * mx_matmul_wo    (_mx_matmul_wo_kernel): out (M, N) = A (M, K) wide
//     (bf16 or f32) x dequant(B)^T, B stored (N, K) blocked along K;
//   * mx_matmul_vv    (_mx_matmul_kernel): both operands MX (paper Eq. 2),
//     A stored (M, K) and B (N, K), same format and block size;
//   * mx_matmul_dgrad (_mx_dgrad_kernel): dx (M, K) = dy (M, N) f32 x
//     dequant(W), reading W's stored (N, K) layout as it is, in bn-row
//     contraction tiles (o += partial in f32).
// Operands are fp8 e4m3 / e5m2 bytes or fp4 e2m1 nibbles (two per byte, low
// first) with one E8M0 byte per block; any block size dividing K.
//
// Arithmetic, as the reference's: each element is decoded to f32 and its
// block's power-of-two scale folded in (exact; flushed to zero below the
// normal range, as the reference's flushed arithmetic reads it), and the
// contraction runs in `bk`-wide tiles in ascending order. With f32
// accumulation the whole contraction sums in f32; with bf16 accumulation
// each tile's f32 partial is rounded to bf16 and added to the bf16 output
// with one more rounding (o += partial.astype(bf16)), so the wrapper passes
// the reference's K-tile width and the kernels round where it does.
//
// What bounds them on an H100 SXM (data-sheet peaks). At granite-8b's gate
// projection (K 4096, N 14336) in fp8, M = 512 rows do 60.1 GFLOP against
// 94 MB of traffic: bound by operations (30 us at the fp8 rate for MX x MX,
// 61 us at the bf16 rate of 989 TFLOP/s for a bf16 A); a decode step's
// M = 8 rows move 61 MB (58.7 MB of them weight codes) for 0.9 GFLOP:
// bound by bytes (18 us at 3.35 TB/s). What bounds this design instead is
// the decode: every weight tile is decoded once per CTA row of tiles and
// every A tile once per CTA column, by the same warps that copy and
// multiply, and the decoded tiles cost shared-memory bandwidth twice
// (written by the decode, read by wgmma). dgrad at M = 512 does three bf16
// products of the split dy, 180 GFLOP (182 us at 989 TFLOP/s), and has no
// single owner of its time: products (whose W operand is read from shared
// memory once per term), W's decode and the copies each take a share, one
// CTA an SM running them in turn. PERF.md gives the measured split.
//
// Design of wo and vv (mx_matmul_tc_kernel). Only the compact bytes cross
// HBM; the tensor cores run the products:
//   * Every element of an fp8 e4m3 / e5m2 or fp4 e2m1 code under any E8M0
//     byte is exact in bf16 once its scale is folded in and subnormals are
//     flushed (bf16 has f32's exponent range). So the kernel decodes MX
//     bytes to bf16 in shared memory (fp8 pairs through the hardware's
//     e4m3x2 / e5m2x2 -> f16x2 conversion, then f32, where the scale is
//     folded in) and runs bf16 x bf16 -> f32 wgmma: every product is exact.
//   * A bf16 A is copied with subnormals flushed (one product). An f32 A is
//     split exactly into three bf16 terms by truncation, hi + mid + lo
//     (mx_matmul.bf16x3_split is the plain version; exact for
//     2^-110 <= |a|), and three products accumulate, hi's apart from mid's
//     and lo's. The low terms are not flushed.
//   * The weight is wgmma's A operand and the activations its B operand,
//     both K-major as stored. A CTA of 512 threads (four warpgroups) owns
//     128 weight rows by bm = 16, 64 or 128 activation rows; warpgroup
//     g multiplies weight rows 64 (g % 2) + [0, 64) by activation rows
//     bm/2 (g / 2) + [0, bm/2) (m64 n(bm/2) k16), so a decode step's 8 rows
//     cost two 64 x 8 tiles, not 64-row ones.
//   * A pipeline over 64-element contraction stages: the next stages' code
//     and E8M0 bytes (or A's rows) arrive in a 2-4-deep ring while the
//     current stage is decoded into a 128-byte-swizzled bf16 tile and the
//     previous stage's wgmma runs (two decoded tiles alternate). Where every
//     stored row is a multiple of 16 bytes, blocks are a multiple of 8
//     elements and K / block a multiple of 16 (the plan's `lean`), one
//     thread asks TMA for a stage's boxes and an mbarrier counts their
//     bytes; elsewhere every thread issues cp.async copies of the 16-byte
//     chunks that cover each row's bytes and the decode runs element by
//     element, so any K, block and base offset works.
//   * Small M fills the card by splitting the contraction over CTAs by bk
//     tiles (mx_matmul.matmul_plan). Each split writes f32 partials to a
//     workspace, one per split (f32) or one per bk tile (bf16), and
//     mx_matmul_reduce_kernel sums them in ascending order, rounding to
//     bf16 where the accumulation is bf16. No float atomics: two calls on
//     the same inputs give the same bits.
//   * The tensor cores add products to their f32 sum with truncation. So
//     with bf16 accumulation each stage's products start a fresh sum that
//     is added to the bk tile's f32 sum with round-to-nearest before the
//     tile rounds to bf16; without a split the bf16 running sum stays
//     packed in registers.
//   * Ragged M, N and K edges: rows beyond M or N are zero (never read),
//     elements beyond a stage's width are zero.
//
// Design of dgrad (mx_dgrad_tc_kernel), the same machinery turned around:
//   * dx (M, K) = dy (M, N) . W with W stored (N, K): the contraction runs
//     over W's rows. A CTA of 512 threads owns bm = 16 or 64 dx rows by 128
//     dx columns and walks N in stages of up to 64 rows of W, each a
//     contiguous 128-column slice of the stored rows (its E8M0 bytes run
//     along the output columns). The stage decodes as stored into two
//     64-column halves, each a 128-byte-swizzled tile whose rows are the
//     contraction index (MN-major), and wgmma reads it as a transposed A
//     (trans-a 1, sw128_desc_mn); dy's rows are the K-major B operand.
//   * f32 dy (flushed) splits exactly into three bf16 terms, hi's products
//     apart from mid's and lo's, as wo's f32 A does; every bn tile (the
//     reference's o += partial) starts fresh tensor-core sums, added to an
//     f32 register sum with round-to-nearest, so a 14336-long contraction
//     does not drift.
//   * Copies are cp.async: where every row is a multiple of 16 bytes each
//     thread issues fixed chunks; else the covering chunks of any offset.
//     Decodes issue all their loads before any conversion.
//   * Small M splits N over CTAs (mx_matmul.dgrad_plan) into an f32
//     workspace summed in ascending order by mx_matmul_reduce_kernel: two
//     calls give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "mx_codec.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// wo and vv: wgmma over MX bytes decoded in shared memory
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 512;  // four warpgroups, 2 x 2 over the tile
constexpr int kBn = 128;         // weight rows of a CTA: two halves of 64
constexpr int kLine = 128;       // bytes of a decoded tile row: 64 bf16
constexpr int kCodeSlot = 80;    // ring bytes of one row's MX codes
constexpr int kScaleSlot = 32;   // ring bytes of one row's E8M0 bytes

enum AKind { kAMx = 0, kABf16 = 1, kAF32 = 2 };

// Shared-memory layout of one instantiation: two decoded tiles, then the
// byte ring (and, on the TMA path, one mbarrier a stage).
//   * TMA path (LEAN): each stage's boxes land densely: 128 weight rows of
//     64 code bytes (fp4 32) and 32 E8M0 bytes, then the A rows: 64 code
//     bytes and 32 E8M0 bytes (MX), 128 bytes (bf16) or 256 (f32). A box
//     starts on a 16-byte column, so the E8M0 box starts at the stage's
//     first block rounded down to 16 and holds its (at most 9) blocks.
//   * cp.async path: a row's slot holds the 16-byte chunks that cover its
//     bytes of the stage: at most 64 code bytes (fp8; fp4 32), 128 (bf16)
//     or 256 (f32), plus 16 of alignment slack; at most 17 E8M0 bytes (a
//     stage spans at most 16 blocks) plus slack.
template <int AK, int BM, bool LEAN>
struct Layout {
  static constexpr int kCodes = LEAN ? 64 : kCodeSlot;
  static constexpr int kScales = kScaleSlot;
  static constexpr int kASlot =
      AK == kAMx ? kCodes : (AK == kABf16 ? 128 : 256) + (LEAN ? 0 : 16);
  static constexpr int kTerms = AK == kAF32 ? 3 : 1;
  static constexpr int kWCodes = 0;
  static constexpr int kWScales = kBn * kCodes;
  static constexpr int kACodes = kWScales + kBn * kScales;
  static constexpr int kAScales = kACodes + BM * kASlot;
  static constexpr int kStage = kAScales + (AK == kAMx ? BM * kScales : 0);
  static constexpr int kWDec = kBn * kLine;  // 16 KB
  static constexpr int kDec = kWDec + kTerms * BM * kLine;
  static constexpr int kRing = 2 * kDec;
  static constexpr int kBars = 128;  // room for the stages' mbarriers
  static constexpr int kFixed = kRing + kBars + 1024;  // + base alignment
  // ring depth: four stages where they fit in the 227 KB a CTA may use
  static constexpr int kStages = kFixed + 4 * kStage <= 232448
                                     ? 4
                                     : (kFixed + 3 * kStage <= 232448 ? 3 : 2);
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(BM % 16 == 0 && (BM / 2 * kLine) % 1024 == 0,
                "each warpgroup's activation rows start on a 1024-byte line");
  static_assert(kStage % 128 == 0, "TMA boxes start on 128-byte lines");
};

struct TcArgs {
  const uint8_t* b;   // weight codes (N, b_stride bytes)
  const uint8_t* bs;  // weight E8M0 (N, nb)
  const uint8_t* a;   // A: MX codes (M, a_stride) or wide rows
  const uint8_t* as;  // A's E8M0 (M, nb), MX only
  void* out;          // (M, N) f32 or bf16
  float* ws;          // split partials (slots, M, N) f32
  int M, N, K;
  int a_stride, b_stride;  // bytes of one stored row
  int nb;                  // E8M0 bytes of one row: K / block
  int block, fmt, bk, w;   // w: contraction elements of one stage
  int k_tiles, tiles_per_split, splits;
  int out_bf16;
};

// the TMA path's tensor maps: weight codes and E8M0 bytes, A's rows (codes,
// bf16 or f32) and A's E8M0 bytes (MX)
struct TmaMaps {
  CUtensorMap w, ws, a, as;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 decoded values -> one 16-byte chunk of a swizzled bf16 tile (exact for
// MX values and bf16 A; the f32 A's terms are exact by construction)
__device__ __forceinline__ void store_chunk(uint8_t* tile, int r, int c,
                                            const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
    w[t] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(tile + r * kLine + ((c ^ (r & 7)) << 4)) = u;
}

// f32 -> (hi, mid, lo) bf16 terms with hi + mid + lo == x: hi and mid by
// truncation (exact, never overflows), lo the exact remainder (at most 8
// significant bits; a bf16 value, subnormal included, for |x| >= 2^-110)
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  const float r = x - hi;
  mid = __uint_as_float(__float_as_uint(r) & 0xFFFF0000u);
  lo = r - mid;
}

// Copy the 16-byte chunks that cover bytes [g * stride + off, + nbytes) of
// each valid row g = row0 + r (< rows) of a (rows, stride) byte array into
// slot r; the last chunk of the array is cut at its end (the rest of the
// 16 bytes is zero-filled).
template <int R, int SLOT>
__device__ __forceinline__ void copy_rows(uint8_t* dst,
                                          const uint8_t* __restrict__ base,
                                          int rows, int stride, int row0,
                                          size_t off, int nbytes) {
  constexpr int kCh = SLOT / 16;
  const size_t total = static_cast<size_t>(rows) * stride;
  for (int i = threadIdx.x; i < R * kCh; i += kTcThreads) {
    const int r = i / kCh, ch = i % kCh;
    const int g = row0 + r;
    if (g >= rows) continue;
    const size_t a = static_cast<size_t>(g) * stride + off;
    const size_t src = (a & ~static_cast<size_t>(15)) + 16 * ch;
    if (src >= a + nbytes) continue;
    const size_t left = total - src;
    const int n = left < 16 ? static_cast<int>(left) : 16;
    cp_async16(dst + r * SLOT + 16 * ch, base + src, n);
  }
}

// two f32 values exact in bf16 (or infinite) -> their bf16 pair, by taking
// the high halves
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// chunks of an R-row tile each thread takes (row tid / 8 + 64 it, chunk
// tid % 8); the last may be partial
template <int R>
__host__ __device__ constexpr int chunk_iters() {
  return (R * 8 + kTcThreads - 1) / kTcThreads;
}

template <int R>
__device__ __forceinline__ bool chunk_live(int it) {
  return R * 8 % kTcThreads == 0 ||
         (threadIdx.x >> 3) + it * (kTcThreads / 8) < R;
}

// The TMA path's MX decode, in two halves: a stage's loads first, then
// the conversions, so that independent chunks overlap their latencies.
// Rows lie densely (64 code bytes, fp4 32; 32 E8M0 bytes from the stage's
// first block rounded down to 16; rows beyond the operand are zero-filled
// and decode to zero), and thread t always takes chunk t % 8 of its rows,
// so its E8M0 byte sits at one column of every row. A factor 2^(S-127)
// with S >= 17 (or S = 0) leaves no nonzero value of the three formats
// below 2^-126: no flush then.
struct MxChunk {
  uint2 u;
  uint32_t sc;
};

template <int R>
__device__ __forceinline__ void load_mx_tma(const TcArgs& p, bool fp4, int k0,
                                            const uint8_t* codes,
                                            const uint8_t* scales,
                                            MxChunk* out) {
  const int c = threadIdx.x & 7;
  const int sidx = (k0 + 8 * c) / p.block - ((k0 / p.block) & ~15);
  const int cb = fp4 ? 32 : 64;
#pragma unroll
  for (int it = 0; it < chunk_iters<R>(); ++it) {
    const int r = (threadIdx.x >> 3) + it * (kTcThreads / 8);
    out[it].u = make_uint2(0u, 0u);
    out[it].sc = 0u;
    if (chunk_live<R>(it)) {
      out[it].sc = scales[r * kScaleSlot + sidx];
      const uint8_t* q = codes + r * cb;
      out[it].u = fp4 ? make_uint2(
                            *reinterpret_cast<const uint32_t*>(q + 4 * c), 0u)
                      : *reinterpret_cast<const uint2*>(q + 8 * c);
    }
  }
}

template <int R>
__device__ __forceinline__ void store_mx_tma(const TcArgs& p, bool fp4,
                                             const MxChunk* in,
                                             uint8_t* tile) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int it = 0; it < chunk_iters<R>(); ++it) {
    if (!chunk_live<R>(it)) break;
    const int r = (threadIdx.x >> 3) + it * (kTcThreads / 8);
    const float fac = mx::e8m0_factor(static_cast<uint8_t>(in[it].sc));
    float v[8];
    if (fp4) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[t] = mx::decode_fp4((in[it].u.x >> (4 * t)) & 0xFu);
      }
    } else {
      mx::fp8x4(in[it].u.x, p.fmt, v);
      mx::fp8x4(in[it].u.y, p.fmt, v + 4);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] *= fac;
    if (in[it].sc - 1u < 16u) {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = mx::flush(v[t]);
    }
    *reinterpret_cast<uint4*>(tile + r * kLine + ((c ^ (r & 7)) << 4)) =
        make_uint4(pack_hi(v[0], v[1]), pack_hi(v[2], v[3]),
                   pack_hi(v[4], v[5]), pack_hi(v[6], v[7]));
  }
}

// bf16 pair with subnormal halves flushed to signed zero
__device__ __forceinline__ uint32_t flush_bf16x2(uint32_t w) {
  uint32_t keep = 0xFFFFFFFFu;
  if ((w & 0x7F80u) == 0) keep &= 0xFFFF8000u;
  if ((w & 0x7F800000u) == 0) keep &= 0x8000FFFFu;
  return w & keep;
}

// issue the copies of stage elements [k0, k0 + w) into ring stage `st`:
// on the TMA path one thread asks for every box and arms the stage's
// barrier with their bytes; else every thread issues its cp.async chunks
template <int AK, int BM, bool LEAN>
__device__ __forceinline__ void issue_stage(const TcArgs& p,
                                            const TmaMaps& maps, int k0,
                                            int fp4, int n0, int m0,
                                            uint8_t* st, uint64_t* bar) {
  using L = Layout<AK, BM, LEAN>;
  const int sb0 = k0 / p.block;
  const int kbyte = fp4 ? k0 / 2 : k0;
  if constexpr (LEAN) {
    if (threadIdx.x != 0) return;
    const int cb = fp4 ? 32 : 64;  // code bytes of a row's stage
    int bytes = kBn * (cb + kScaleSlot);
    if constexpr (AK == kAMx) {
      bytes += BM * (cb + kScaleSlot);
    } else {
      bytes += BM * (AK == kAF32 ? 256 : 128);
    }
    mbar_expect(bar, bytes);
    tma_load(st + L::kWCodes, &maps.w, kbyte, n0, bar);
    tma_load(st + L::kWScales, &maps.ws, sb0 & ~15, n0, bar);
    if constexpr (AK == kAMx) {
      tma_load(st + L::kACodes, &maps.a, kbyte, m0, bar);
      tma_load(st + L::kAScales, &maps.as, sb0 & ~15, m0, bar);
    } else {
      tma_load(st + L::kACodes, &maps.a, k0, m0, bar);
    }
  } else {
    const int nsb = (k0 + p.w - 1) / p.block - sb0 + 1;
    const int kbytes = fp4 ? p.w / 2 : p.w;
    constexpr int es = AK == kAF32 ? 4 : 2;  // wide A's element bytes
    copy_rows<kBn, kCodeSlot>(st + L::kWCodes, p.b, p.N, p.b_stride, n0,
                              kbyte, kbytes);
    copy_rows<kBn, kScaleSlot>(st + L::kWScales, p.bs, p.N, p.nb, n0, sb0,
                               nsb);
    if constexpr (AK == kAMx) {
      copy_rows<BM, kCodeSlot>(st + L::kACodes, p.a, p.M, p.a_stride, m0,
                               kbyte, kbytes);
      copy_rows<BM, kScaleSlot>(st + L::kAScales, p.as, p.M, p.nb, m0, sb0,
                                nsb);
    } else {
      copy_rows<BM, L::kASlot>(st + L::kACodes, p.a, p.M, p.a_stride, m0,
                               static_cast<size_t>(k0) * es, p.w * es);
    }
  }
}

// The cp.async path's MX decode: rows [row0, row0 + R) of a stage into a
// decoded tile, element by element (mx_codec.cuh); chunk c of row r holds
// elements [8c, 8c + 8) of the stage, zero beyond w and beyond rows. A
// row's bytes start at its offset in the first chunk that covers them.
template <int R>
__device__ __forceinline__ void decode_mx(const TcArgs& p,
                                          const mx::FmtSpec& f, int k0,
                                          const uint8_t* codes,
                                          const uint8_t* scales, int rows,
                                          int stride, int row0,
                                          uint8_t* tile) {
  const int kbyte = f.bits == 4 ? k0 / 2 : k0;
  const int sb0 = k0 / p.block;
  for (int i = threadIdx.x; i < R * 8; i += kTcThreads) {
    const int r = i >> 3, c = i & 7;
    const int g = row0 + r;
    const uint8_t* q = codes + r * kCodeSlot + static_cast<int>(
        (static_cast<size_t>(g) * stride + kbyte) & 15);
    const uint8_t* s = scales + r * kScaleSlot + static_cast<int>(
        (static_cast<size_t>(g) * p.nb + sb0) & 15);
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = 8 * c + t;
      v[t] = g < rows && e < p.w
                 ? mx::flush(mx::element_value(q, e, f, p.fmt) *
                             mx::e8m0_factor(s[(k0 + e) / p.block - sb0]))
                 : 0.0f;
    }
    store_chunk(tile, r, c, v);
  }
}

// The TMA path's wide A: rows of 64 values lie densely (zero beyond M); 8
// values of a row per thread, loaded before any is converted
template <int R, bool F32>
struct WideChunks {
  uint4 u[chunk_iters<R>()][F32 ? 2 : 1];
};

template <int R, bool F32>
__device__ __forceinline__ void load_wide_tma(const uint8_t* raw,
                                              WideChunks<R, F32>& out) {
  constexpr int kRow = F32 ? 256 : 128;
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int it = 0; it < chunk_iters<R>(); ++it) {
    const int r = (threadIdx.x >> 3) + it * (kTcThreads / 8);
#pragma unroll
    for (int h = 0; h < (F32 ? 2 : 1); ++h) {
      out.u[it][h] = chunk_live<R>(it)
                         ? *reinterpret_cast<const uint4*>(
                               raw + r * kRow + (F32 ? 32 : 16) * c + 16 * h)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int R, bool F32>
__device__ __forceinline__ void store_wide_tma(const WideChunks<R, F32>& in,
                                               uint8_t* tile) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int it = 0; it < chunk_iters<R>(); ++it) {
    if (!chunk_live<R>(it)) break;
    const int r = (threadIdx.x >> 3) + it * (kTcThreads / 8);
    uint8_t* dst = tile + r * kLine + ((c ^ (r & 7)) << 4);
    if constexpr (F32) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(in.u[it]);
      float hi[8], mid[8], lo[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        split3(mx::flush(__uint_as_float(w[t])), hi[t], mid[t], lo[t]);
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_hi(hi[0], hi[1]), pack_hi(hi[2], hi[3]),
                     pack_hi(hi[4], hi[5]), pack_hi(hi[6], hi[7]));
      *reinterpret_cast<uint4*>(dst + R * kLine) =
          make_uint4(pack_hi(mid[0], mid[1]), pack_hi(mid[2], mid[3]),
                     pack_hi(mid[4], mid[5]), pack_hi(mid[6], mid[7]));
      store_chunk(tile + 2 * R * kLine, r, c, lo);
    } else {
      const uint4 x = in.u[it][0];
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(flush_bf16x2(x.x), flush_bf16x2(x.y), flush_bf16x2(x.z),
                     flush_bf16x2(x.w));
    }
  }
}

// The cp.async path's wide A: rows [row0, row0 + R) (bf16 or f32,
// subnormals flushed) into the decoded tile(s), element by element: bf16
// as it is, f32 as its three bf16 terms. A row's bytes start at its offset
// in the first chunk that covers them (a multiple of the element size).
template <int R, bool F32>
__device__ __forceinline__ void decode_wide(const TcArgs& p, int k0,
                                            const uint8_t* raw, int row0,
                                            uint8_t* tile) {
  constexpr int es = F32 ? 4 : 2;
  constexpr int slot = F32 ? 272 : 144;
  for (int i = threadIdx.x; i < R * 8; i += kTcThreads) {
    const int r = i >> 3, c = i & 7;
    const int g = row0 + r;
    const uint8_t* q = raw + r * slot + 8 * es * c + static_cast<int>(
        (static_cast<size_t>(g) * p.a_stride + static_cast<size_t>(k0) * es)
        & 15);
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float x = 0.0f;
      if (g < p.M && 8 * c + t < p.w) {
        if constexpr (F32) {
          x = *reinterpret_cast<const float*>(q + 4 * t);
        } else {
          x = __uint_as_float(static_cast<uint32_t>(
                  *reinterpret_cast<const uint16_t*>(q + 2 * t)) << 16);
        }
      }
      v[t] = mx::flush(x);
    }
    if constexpr (F32) {
      float hi[8], mid[8], lo[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) split3(v[t], hi[t], mid[t], lo[t]);
      store_chunk(tile, r, c, hi);
      store_chunk(tile + R * kLine, r, c, mid);
      store_chunk(tile + 2 * R * kLine, r, c, lo);
    } else {
      store_chunk(tile, r, c, v);
    }
  }
}

// the accumulator fragment of this thread: element (row n, column m) of
// its warpgroup's 64 x BM/2 tile, out[m][n] of the CTA's (m0, n0) tile.
// Warpgroup g takes weight rows 64 (g % 2) + [0, 64) and activation rows
// BM/2 (g / 2) + [0, BM/2).
template <int BM, class Store>
__device__ __forceinline__ void for_fragment(int n0, int m0, Store store) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int lane = t % 32;
  const int n = n0 + 64 * (wg & 1) + 16 * (t / 32) + lane / 4;
  const int m = m0 + (BM / 2) * (wg >> 1) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BM / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) store(4 * j + 2 * h + e, m + 8 * j + e,
                                        n + 8 * h);
}

template <int BM>
__device__ __forceinline__ void store_f32(const float* acc, float* dst,
                                          int M, int N, int m0, int n0) {
  for_fragment<BM>(n0, m0, [&](int i, int m, int n) {
    if (m < M && n < N) dst[static_cast<size_t>(m) * N + n] = acc[i];
  });
}

template <int AK, int BM, bool LEAN>
__global__ void __launch_bounds__(kTcThreads, BM <= 16 ? 2 : 1)
    mx_matmul_tc_kernel(TcArgs p, const __grid_constant__ TmaMaps maps) {
  using L = Layout<AK, BM, LEAN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::kRing;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  const mx::FmtSpec f = mx::fmt_spec(p.fmt);
  const int fp4 = f.bits == 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBn;
  const int t0 = blockIdx.z * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, p.k_tiles);
  const int per_tile = p.bk / p.w;  // stages of one bk tile
  const int nst = (t1 - t0) * per_tile;
  const int kbase = t0 * p.bk;
  const int nks = LEAN ? 4 : (p.w + 15) / 16;  // k16 steps of a stage
  const int wg = threadIdx.x / 128;

  // An f32 A's mid and lo products sum in acc2, apart from hi's: the
  // tensor cores add each product to their f32 sum with truncation, so
  // terms 2^8 and 2^16 times smaller than the sum would lose their low bits.
  // For the same reason a long tensor-core sum drifts (K 14336 at M 512:
  // 8e-7 of |A|.|B|^T, where an f32 FMA loop stays near 2e-8): every bk
  // tile's products (with bf16 accumulation, every stage's) start a fresh
  // tensor-core sum, and the CTA adds it to `tsum` with round-to-nearest.
  // With f32 accumulation tsum is the result; with bf16 it is the tile's
  // partial, which rounds into the bf16 running sum `run` (pairs, without
  // a split) or goes to the workspace.
  constexpr int kAcc = BM / 4;  // a warpgroup's 64 x BM/2 fragment
  constexpr int kAcc2 = AK == kAF32 ? kAcc : 1;
  constexpr bool kBf16 = BM <= 64;  // the plan takes bf16 there only
  float acc[kAcc], acc2[kAcc2], tsum[kAcc];
  uint32_t run[kBf16 ? kAcc / 2 : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = tsum[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kAcc2; ++i) acc2[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kBf16 ? kAcc / 2 : 1); ++i) run[i] = 0u;
  const bool bf16_acc = kBf16 && p.out_bf16;

  if constexpr (LEAN) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < L::kStages; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < nst) {
      issue_stage<AK, BM, LEAN>(p, maps, kbase + i * p.w, fp4, n0, m0,
                                ring + i * L::kStage, bars + i);
    }
    if constexpr (!LEAN) cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    const int j = i + L::kStages - 1;
    if (j < nst) {  // into the stage that stage i - 1 left
      const int slot = j % L::kStages;
      issue_stage<AK, BM, LEAN>(p, maps, kbase + j * p.w, fp4, n0, m0,
                                ring + slot * L::kStage, bars + slot);
    }
    if constexpr (LEAN) {
      mbar_wait(bars + i % L::kStages, (i / L::kStages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<L::kStages - 1>();
    }
    // every warpgroup is past its products of stage i - 2, whose decoded
    // tile stage i overwrites
    __syncthreads();
    const int k0 = kbase + i * p.w;
    const uint8_t* st = ring + (i % L::kStages) * L::kStage;
    uint8_t* dec = smem + (i & 1) * L::kDec;
    if constexpr (LEAN) {
      // every load of the stage first, then the conversions: independent
      // chunks overlap their latencies
      MxChunk wl[chunk_iters<kBn>()];
      load_mx_tma<kBn>(p, fp4, k0, st + L::kWCodes, st + L::kWScales, wl);
      if constexpr (AK == kAMx) {
        MxChunk al[chunk_iters<BM>()];
        load_mx_tma<BM>(p, fp4, k0, st + L::kACodes, st + L::kAScales, al);
        store_mx_tma<kBn>(p, fp4, wl, dec);
        store_mx_tma<BM>(p, fp4, al, dec + L::kWDec);
      } else {
        WideChunks<BM, AK == kAF32> al;
        load_wide_tma<BM, AK == kAF32>(st + L::kACodes, al);
        store_mx_tma<kBn>(p, fp4, wl, dec);
        store_wide_tma<BM, AK == kAF32>(al, dec + L::kWDec);
      }
    } else {
      decode_mx<kBn>(p, f, k0, st + L::kWCodes, st + L::kWScales, p.N,
                     p.b_stride, n0, dec);
      if constexpr (AK == kAMx) {
        decode_mx<BM>(p, f, k0, st + L::kACodes, st + L::kAScales, p.M,
                      p.a_stride, m0, dec + L::kWDec);
      } else {
        decode_wide<BM, AK == kAF32>(p, k0, st + L::kACodes, m0,
                                     dec + L::kWDec);
      }
    }
    fence_proxy_async();
    __syncthreads();

    wgmma_fence();
    const bool fresh = bf16_acc || i % per_tile == 0;
    const uint64_t dw = sw128_desc(dec + (wg & 1) * 64 * kLine);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (LEAN || ks < nks) {
        const int sd = fresh && ks == 0 ? 0 : 1;
#pragma unroll
        for (int term = 0; term < L::kTerms; ++term) {
          const uint64_t da = sw128_desc(dec + L::kWDec + term * BM * kLine +
                                         (wg >> 1) * (BM / 2) * kLine);
          if (term == 0) {
            wgmma_bf16<BM / 2>(acc, dw + 2 * ks, da + 2 * ks, sd);
          } else {
            wgmma_bf16<BM / 2>(acc2, dw + 2 * ks, da + 2 * ks,
                               term == 1 ? sd : 1);
          }
        }
      }
    }
    wgmma_commit();
    const bool tile_end = (i + 1) % per_tile == 0;
    if (!bf16_acc && !tile_end) {
      // stage i's products run on while stage i + 1 is decoded; no other
      // instruction touches the accumulators until they are added to tsum
      // (an operand fence here would make the compiler wait for them)
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    fence_regs<kAcc2>(acc2);
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      if constexpr (AK == kAF32) {
        tsum[q] += acc[q] + acc2[q];
      } else {
        tsum[q] += acc[q];
      }
    }
    if constexpr (kBf16) {
      if (bf16_acc && tile_end) {
        // the bk tile's f32 partial rounds into the bf16 sum
        if (p.splits > 1) {
          const int t = t0 + (i + 1) / per_tile - 1;
          store_f32<BM>(tsum, p.ws + static_cast<size_t>(t) * p.M * p.N,
                        p.M, p.N, m0, n0);
        } else {
#pragma unroll
          for (int q = 0; q < kAcc / 2; ++q) {
            __nv_bfloat162 s2 = *reinterpret_cast<__nv_bfloat162*>(&run[q]);
            const float2 r2 = __bfloat1622float2(s2);
            s2 = __floats2bfloat162_rn(r2.x + round_bf16(tsum[2 * q]),
                                       r2.y + round_bf16(tsum[2 * q + 1]));
            run[q] = *reinterpret_cast<uint32_t*>(&s2);
          }
        }
#pragma unroll
        for (int q = 0; q < kAcc; ++q) tsum[q] = 0.0f;
      }
    }
  }

  if constexpr (kBf16) {
    if (bf16_acc) {
      if (p.splits > 1) return;  // every tile's partial is in the workspace
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
      for_fragment<BM>(n0, m0, [&](int i, int m, int n) {
        if (m < p.M && n < p.N) {
          const __nv_bfloat162 s2 =
              *reinterpret_cast<const __nv_bfloat162*>(&run[i / 2]);
          out[static_cast<size_t>(m) * p.N + n] = (i & 1) ? s2.y : s2.x;
        }
      });
      return;
    }
  }
  if (p.splits > 1) {
    store_f32<BM>(tsum, p.ws + static_cast<size_t>(blockIdx.z) * p.M * p.N,
                  p.M, p.N, m0, n0);
  } else {
    store_f32<BM>(tsum, static_cast<float*>(p.out), p.M, p.N, m0, n0);
  }
}

// out = the workspace's slots summed in ascending order: f32, or with
// bf16 accumulation o = bf16(o + bf16(partial)) per slot (one per bk tile)
__global__ void __launch_bounds__(256) mx_matmul_reduce_kernel(
    const float* __restrict__ ws, void* out, long long count, int slots,
    int out_bf16) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * 256) {
    if (out_bf16) {
      float o = 0.0f;
      for (int s = 0; s < slots; ++s) {
        o = round_bf16(o + round_bf16(ws[s * count + i]));
      }
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(o);
    } else {
      float o = ws[i];
      for (int s = 1; s < slots; ++s) o += ws[s * count + i];
      static_cast<float*>(out)[i] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// dgrad: dx (M, K) = dy (M, N) f32 x dequant(W (N, K)) on the tensor cores
// ---------------------------------------------------------------------------
//
// The wo kernel's machinery with the roles of W's axes swapped: the
// contraction runs over W's rows n, and a CTA's 128 output columns are
// 128 consecutive k of every row. In TcArgs terms (set by the launcher):
// A = dy (M rows of N f32), "N" = K (dx columns), "K" = N (the
// contraction), bk = bn, b_stride / nb = W's stored row.

constexpr int kDgCols = 128;  // dx columns of a CTA: two warpgroup halves

// Shared memory of the dgrad kernel: two decoded buffers (W's stage as two
// MN-major 64-column halves, then dy's three bf16 terms), then the ring.
// A W row's slot holds the 16-byte chunks covering its 128 code bytes
// (fp4 64) and its E8M0 bytes of the 128 columns (at most 129, block 1),
// each with 16 of alignment slack; a dy row's its 64 f32 values.
template <int BM>
struct DgLayout {
  static constexpr int kCodes = 144;
  static constexpr int kScales = 144;
  static constexpr int kARow = 272;
  static constexpr int kWCodes = 0;
  static constexpr int kWScales = 64 * kCodes;
  static constexpr int kA = kWScales + 64 * kScales;
  static constexpr int kStage = kA + BM * kARow;
  static constexpr int kWDec = 2 * 64 * kLine;
  static constexpr int kDec = kWDec + 3 * BM * kLine;
  static constexpr int kRing = 2 * kDec;
  static constexpr int kFixed = kRing + 1024;  // + base alignment
  // bm 16 runs two CTAs an SM: each takes half of the SM's shared memory
  static constexpr int kBudget = BM <= 16 ? 232448 / 2 - 1024 : 232448;
  static constexpr int kStages =
      kFixed + 4 * kStage <= kBudget
          ? 4
          : (kFixed + 3 * kStage <= kBudget ? 3 : 2);
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kStage % 16 == 0 && kDec % 1024 == 0, "aligned tiles");
  static_assert(kSmem <= kBudget, "the ring fits");
};

// issue the cp.async copies of contraction stage [s0, s0 + w): W rows s0 +
// [0, 64) at dx columns [c0, c0 + 128) (codes and E8M0 bytes), dy rows m0 +
// [0, BM) at [s0, s0 + w)
template <int BM>
__device__ __forceinline__ void issue_dgrad_stage(const TcArgs& p, int s0,
                                                  int fp4, int c0, int m0,
                                                  uint8_t* st) {
  using L = DgLayout<BM>;
  const int cols = min(kDgCols, p.N - c0);
  const int sb0 = c0 / p.block;
  copy_rows<64, L::kCodes>(st + L::kWCodes, p.b, p.K, p.b_stride, s0,
                           fp4 ? c0 / 2 : c0, fp4 ? cols / 2 : cols);
  copy_rows<64, L::kScales>(st + L::kWScales, p.bs, p.K, p.nb, s0, sb0,
                            (c0 + cols - 1) / p.block - sb0 + 1);
  copy_rows<BM, L::kARow>(st + L::kA, p.a, p.M, p.a_stride, m0,
                          static_cast<size_t>(s0) * 4, p.w * 4);
}

// The same copies where every row starts on 16 bytes (the launcher's fast
// bit 2: W's rows, its E8M0 rows and dy's rows multiples of 16 bytes, the
// stage a multiple of 4 wide, blocks of 8k): a thread's chunks are fixed
// (W codes: row t / 8, chunk t % 8; E8M0: row t, one chunk holding the
// tile's at most 16 bytes; dy: rows t / 16 + 32 j, chunk t % 16; rows past
// the stage width skipped), so a stage costs each thread at most 4
// address computations and copies.
template <int BM>
__device__ __forceinline__ void issue_dgrad_stage_rows(const TcArgs& p,
                                                       int s0, int fp4,
                                                       int c0, int m0,
                                                       uint8_t* st) {
  using L = DgLayout<BM>;
  const int t = threadIdx.x;
  const int cols = min(kDgCols, p.N - c0);
  {
    const int r = t >> 3, ch = t & 7;
    const int off = (fp4 ? c0 / 2 : c0) + 16 * ch;
    if (r < p.w && 16 * ch < (fp4 ? cols / 2 : cols)) {
      cp_async16(st + L::kWCodes + r * L::kCodes + 16 * ch,
                 p.b + static_cast<size_t>(s0 + r) * p.b_stride + off, 16);
    }
  }
  if (t < p.w) {
    const int sb0 = c0 / p.block;
    cp_async16(st + L::kWScales + t * L::kScales,
               p.bs + static_cast<size_t>(s0 + t) * p.nb + (sb0 & ~15), 16);
  }
#pragma unroll
  for (int j = 0; j < (BM * 16 + kTcThreads - 1) / kTcThreads; ++j) {
    const int r = (t >> 4) + 32 * j, ch = t & 15;
    if (r < BM && m0 + r < p.M && 4 * ch < p.w) {
      cp_async16(st + L::kA + r * L::kARow + 16 * ch,
                 p.a + static_cast<size_t>(m0 + r) * p.a_stride +
                     static_cast<size_t>(s0) * 4 + 16 * ch,
                 16);
    }
  }
}

// W's stage into the decoded buffer: chunk c (columns c0 + 8c + [0, 8)) of
// stage row r goes to half c / 8, row r, chunk c % 8 of the swizzle, so
// each half is an MN-major tile (row = contraction index). Rows beyond the
// stage and columns beyond K are zero. `fast` (block a multiple of 8,
// stored rows a multiple of 16 bytes): a chunk's 8 codes are one load and
// share one E8M0 byte; else element by element.
__device__ __forceinline__ void decode_dgrad_w(const TcArgs& p,
                                               const mx::FmtSpec& f, int fast,
                                               int s0, int c0,
                                               const uint8_t* codes,
                                               const uint8_t* scales,
                                               uint8_t* tile) {
  constexpr int kIt = 64 * 16 / kTcThreads;  // rows a thread takes
  const int cols = min(kDgCols, p.N - c0);
  const bool fp4 = f.bits == 4;
  const int cbyte = fp4 ? c0 / 2 : c0;
  const int sb0 = c0 / p.block;
  // a thread keeps its chunk c for every row it takes
  const int c = threadIdx.x & 15;
  const int r0 = threadIdx.x >> 4;
  auto store = [&](int r, const float* v) {
    uint8_t* half = tile + (c >> 3) * 64 * kLine;
    *reinterpret_cast<uint4*>(half + r * kLine +
                              (((c & 7) ^ (r & 7)) << 4)) =
        make_uint4(pack_hi(v[0], v[1]), pack_hi(v[2], v[3]),
                   pack_hi(v[4], v[5]), pack_hi(v[6], v[7]));
  };
  if (fast && 8 * c + 8 <= cols) {
    // every row's bytes start on 16 bytes: all loads first, then the
    // conversions, so that the rows' latencies overlap
    const int sidx = (c0 + 8 * c) / p.block - sb0;
    uint2 u[kIt];
    uint32_t sc[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int r = r0 + it * (kTcThreads / 16);
      u[it] = fp4 ? make_uint2(*reinterpret_cast<const uint32_t*>(
                                   codes + r * DgLayout<16>::kCodes + 4 * c),
                               0u)
                  : *reinterpret_cast<const uint2*>(
                        codes + r * DgLayout<16>::kCodes + 8 * c);
      sc[it] = scales[r * DgLayout<16>::kScales + sidx + static_cast<int>(
          (static_cast<size_t>(s0 + r) * p.nb + sb0) & 15)];
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int r = r0 + it * (kTcThreads / 16);
      float v[8];
      if (fp4) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[t] = mx::decode_fp4((u[it].x >> (4 * t)) & 0xFu);
        }
      } else {
        mx::fp8x4(u[it].x, p.fmt, v);
        mx::fp8x4(u[it].y, p.fmt, v + 4);
      }
      const float fac = mx::e8m0_factor(static_cast<uint8_t>(sc[it]));
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] *= fac;
      if (sc[it] - 1u < 16u) {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = mx::flush(v[t]);
      }
      if (r >= p.w) {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = 0.0f;
      }
      store(r, v);
    }
    return;
  }
  for (int it = 0; it < kIt; ++it) {
    const int r = r0 + it * (kTcThreads / 16);
    const int g = s0 + r;
    const uint8_t* q = codes + r * DgLayout<16>::kCodes + static_cast<int>(
        (static_cast<size_t>(g) * p.b_stride + cbyte) & 15);
    const uint8_t* s = scales + r * DgLayout<16>::kScales + static_cast<int>(
        (static_cast<size_t>(g) * p.nb + sb0) & 15);
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = 8 * c + t;
      v[t] = r < p.w && e < cols
                 ? mx::flush(mx::element_value(q, e, f, p.fmt) *
                             mx::e8m0_factor(s[(c0 + e) / p.block - sb0]))
                 : 0.0f;
    }
    store(r, v);
  }
}

// dy's stage as three bf16 terms, 4 values a thread from one 16-byte read
// (every row's stage offset a multiple of 16 bytes: N and the stage width
// multiples of 4), written as 8-byte halves of the swizzled chunks; rows
// beyond M and values beyond the stage are zero. decode_wide is the
// general path.
template <int R>
__device__ __forceinline__ void decode_dy_vec(const TcArgs& p,
                                              const uint8_t* raw, int row0,
                                              uint8_t* tile) {
  constexpr int kRow = DgLayout<16>::kARow;
  constexpr int kIt = (R * 16 + kTcThreads - 1) / kTcThreads;
  const int h = threadIdx.x & 15;
  float4 x[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int r = (threadIdx.x >> 4) + it * (kTcThreads / 16);
    x[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < R && row0 + r < p.M && 4 * h < p.w) {
      x[it] = *reinterpret_cast<const float4*>(raw + r * kRow + 16 * h);
    }
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int r = (threadIdx.x >> 4) + it * (kTcThreads / 16);
    if (r >= R) break;
    const float v[4] = {mx::flush(x[it].x), mx::flush(x[it].y),
                        mx::flush(x[it].z), mx::flush(x[it].w)};
    float hi[4], mid[4], lo[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) split3(v[t], hi[t], mid[t], lo[t]);
    const int off = r * kLine + (((h >> 1) ^ (r & 7)) << 4) + 8 * (h & 1);
    *reinterpret_cast<uint2*>(tile + off) =
        make_uint2(pack_hi(hi[0], hi[1]), pack_hi(hi[2], hi[3]));
    *reinterpret_cast<uint2*>(tile + R * kLine + off) =
        make_uint2(pack_hi(mid[0], mid[1]), pack_hi(mid[2], mid[3]));
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(lo[0], lo[1]);
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(lo[2], lo[3]);
    *reinterpret_cast<uint2*>(tile + 2 * R * kLine + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&l0),
                   *reinterpret_cast<const uint32_t*>(&l1));
  }
}

// One CTA: dx rows m0 + [0, BM) by columns c0 + [0, 128), over the bn
// tiles [t0, t1) of its split. Warpgroup g multiplies columns 64 (g % 2) +
// [0, 64) (A: W's decoded half, MN-major) by rows BM/2 (g / 2) + [0, BM/2)
// (B: dy's terms, K-major). dy splits exactly into three bf16 terms, hi's
// products apart from mid's and lo's; every bn tile starts fresh
// tensor-core sums, added to tsum with round-to-nearest at its end (the
// reference's o += partial, and no truncation drift over N).
// FULL: 64-wide stages (four k16 steps, none skipped).
template <int BM, bool FULL>
__global__ void __launch_bounds__(kTcThreads, BM <= 16 ? 2 : 1)
    mx_dgrad_tc_kernel(TcArgs p, int fast) {
  using L = DgLayout<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::kRing;
  const mx::FmtSpec f = mx::fmt_spec(p.fmt);
  const int fp4 = f.bits == 4;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * kDgCols;
  const int t0 = blockIdx.z * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, p.k_tiles);
  const int per_tile = p.bk / p.w;
  const int nst = (t1 - t0) * per_tile;
  const int kbase = t0 * p.bk;
  const int nks = FULL ? 4 : (p.w + 15) / 16;
  const int wg = threadIdx.x / 128;
  constexpr int kAcc = BM / 4;
  float acc[kAcc], acc2[kAcc], tsum[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = acc2[i] = tsum[i] = 0.0f;

  auto issue = [&](int k, uint8_t* st) {
    if (fast & 4) {
      issue_dgrad_stage_rows<BM>(p, kbase + k * p.w, fp4, c0, m0, st);
    } else {
      issue_dgrad_stage<BM>(p, kbase + k * p.w, fp4, c0, m0, st);
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < nst) issue(i, ring + i * L::kStage);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    const int j = i + L::kStages - 1;
    if (j < nst) issue(j, ring + (j % L::kStages) * L::kStage);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    // every warpgroup is past its products of stage i - 2, whose decoded
    // buffer stage i overwrites
    __syncthreads();
    const int s0 = kbase + i * p.w;
    const uint8_t* st = ring + (i % L::kStages) * L::kStage;
    uint8_t* dec = smem + (i & 1) * L::kDec;
    decode_dgrad_w(p, f, fast & 1, s0, c0, st + L::kWCodes,
                   st + L::kWScales, dec);
    if (fast & 2) {
      decode_dy_vec<BM>(p, st + L::kA, m0, dec + L::kWDec);
    } else {
      decode_wide<BM, true>(p, s0, st + L::kA, m0, dec + L::kWDec);
    }
    fence_proxy_async();
    __syncthreads();

    wgmma_fence();
    const bool fresh = i % per_tile == 0;
    const uint64_t dw = sw128_desc_mn(dec + (wg & 1) * 64 * kLine);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (FULL || ks < nks) {
        const int sd = fresh && ks == 0 ? 0 : 1;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint64_t da = sw128_desc(dec + L::kWDec + term * BM * kLine +
                                         (wg >> 1) * (BM / 2) * kLine);
          if (term == 0) {
            wgmma_bf16<BM / 2, 1>(acc, dw + 128 * ks, da + 2 * ks, sd);
          } else {
            wgmma_bf16<BM / 2, 1>(acc2, dw + 128 * ks, da + 2 * ks,
                                  term == 1 ? sd : 1);
          }
        }
      }
    }
    wgmma_commit();
    if ((i + 1) % per_tile != 0) {
      // stage i's products run on while stage i + 1 is decoded
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    fence_regs<kAcc>(acc2);
#pragma unroll
    for (int q = 0; q < kAcc; ++q) tsum[q] += acc[q] + acc2[q];
  }
  float* dst = p.splits > 1
                   ? p.ws + static_cast<size_t>(blockIdx.z) * p.M * p.N
                   : static_cast<float*>(p.out);
  store_f32<BM>(tsum, dst, p.M, p.N, m0, c0);
}

template <int BM, bool FULL>
int launch_dgrad(const TcArgs& p, int fast, int m_tiles, int col_tiles,
                 cudaStream_t s) {
  using L = DgLayout<BM>;
  auto kernel = mx_dgrad_tc_kernel<BM, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(m_tiles, col_tiles, p.splits), kTcThreads, L::kSmem, s>>>(
      p, fast);
  return static_cast<int>(cudaGetLastError());
}

template <int AK, int BM, bool LEAN>
int launch_tc(const TcArgs& p, const TmaMaps& maps, int m_tiles, int n_tiles,
              cudaStream_t s) {
  using L = Layout<AK, BM, LEAN>;
  auto kernel = mx_matmul_tc_kernel<AK, BM, LEAN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(m_tiles, n_tiles, p.splits), kTcThreads, L::kSmem, s>>>(p,
                                                                       maps);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: bm 16 and 64 on both paths and any accumulation;
// bm 128 on the TMA path, with f32 accumulation and a bf16 or MX A (its
// accumulators and tile sums take 64 registers a thread; at bm 256 they
// would take the whole register file)
template <int AK>
int launch_tc_bm(const TcArgs& p, const TmaMaps& maps, int bm, bool lean,
                 int m_tiles, int n_tiles, cudaStream_t s) {
  if (bm == 16) {
    return lean ? launch_tc<AK, 16, true>(p, maps, m_tiles, n_tiles, s)
                : launch_tc<AK, 16, false>(p, maps, m_tiles, n_tiles, s);
  }
  if (bm == 64) {
    return lean ? launch_tc<AK, 64, true>(p, maps, m_tiles, n_tiles, s)
                : launch_tc<AK, 64, false>(p, maps, m_tiles, n_tiles, s);
  }
  if constexpr (AK != kAF32) {
    if (lean && !p.out_bf16 && bm == 128) {
      return launch_tc<AK, 128, true>(p, maps, m_tiles, n_tiles, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 2D map over `rows` rows of `cols` elements, `stride` bytes apart, read in
// boxes of bx x by elements (rows beyond the array are zero-filled)
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                int cols, int rows, int stride, int bx, int by) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bx),
                             static_cast<cuuint32_t>(by)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Each launcher returns cudaGetLastError() after its launches. Sizes are
// logical; strides are bytes of one stored row.

// wo (a_kind 1 bf16, 2 f32) and vv (a_kind 0, with a_scales): one
// mx_matmul_tc_kernel launch over (m_tiles, n_tiles, splits) CTAs of the
// plan (mx_matmul.matmul_plan), then, with splits > 1, one reduce launch
// over the workspace's `slots` partials. `lean` (the plan's) takes the TMA
// path: 64-element stages, blocks of a multiple of 8, every row of codes,
// E8M0 bytes and A a multiple of 16 bytes.
extern "C" int mx_matmul_tc_launch(
    const void* a, const void* a_scales, int a_kind, const void* b,
    const void* b_scales, void* out, void* ws, int M, int N, int K,
    int a_stride, int b_stride, int block, int fmt, int bk, int w, int bm,
    int splits, int tiles_per_split, int slots, int out_bf16, int lean,
    void* stream) {
  TcArgs p;
  p.b = static_cast<const uint8_t*>(b);
  p.bs = static_cast<const uint8_t*>(b_scales);
  p.a = static_cast<const uint8_t*>(a);
  p.as = static_cast<const uint8_t*>(a_scales);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.M = M; p.N = N; p.K = K;
  p.a_stride = a_stride; p.b_stride = b_stride;
  p.nb = K / block;
  p.block = block; p.fmt = fmt; p.bk = bk; p.w = w;
  p.k_tiles = K / bk;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  p.out_bf16 = out_bf16;
  TmaMaps maps = {};
  if (lean) {
    if (w != 64 || block % 8 || p.nb % 16 || a_stride % 16 || b_stride % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cb = fmt == 4 ? 32 : 64;  // fp4 codes of a 64-element stage
    bool ok = tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, b_stride,
                         N, b_stride, cb, kBn) &&
              tensor_map(&maps.ws, CU_TENSOR_MAP_DATA_TYPE_UINT8, b_scales,
                         p.nb, N, p.nb, kScaleSlot, kBn);
    if (a_kind == kAMx) {
      ok = ok &&
           tensor_map(&maps.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, a_stride, M,
                      a_stride, cb, bm) &&
           tensor_map(&maps.as, CU_TENSOR_MAP_DATA_TYPE_UINT8, a_scales, p.nb,
                      M, p.nb, kScaleSlot, bm);
    } else {
      ok = ok && tensor_map(&maps.a,
                            a_kind == kAF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            a, K, M, a_stride, 64, bm);
    }
    if (!ok) return static_cast<int>(cudaErrorNotSupported);
  }
  const int m_tiles = (M + bm - 1) / bm, n_tiles = (N + kBn - 1) / kBn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (a_kind) {
    case kAMx:
      err = launch_tc_bm<kAMx>(p, maps, bm, lean, m_tiles, n_tiles, s);
      break;
    case kABf16:
      err = launch_tc_bm<kABf16>(p, maps, bm, lean, m_tiles, n_tiles, s);
      break;
    case kAF32:
      err = launch_tc_bm<kAF32>(p, maps, bm, lean, m_tiles, n_tiles, s);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || splits <= 1) return err;
  const long long count = static_cast<long long>(M) * N;
  const long long want = (count + 255) / 256;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  mx_matmul_reduce_kernel<<<grid, 256, 0, s>>>(p.ws, out, count, slots,
                                               out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// dgrad: one mx_dgrad_tc_kernel launch over (m_tiles, col_tiles, splits)
// CTAs of the plan (mx_matmul.dgrad_plan), then, with splits > 1, one
// reduce launch over the workspace's `splits` partials (ascending order).
// b_stride: bytes of one stored W row; bn: the contraction tile; w: the
// stage width (a divisor of bn, at most 64); fast: the plan's vector decode.
extern "C" int mx_matmul_dgrad_launch(
    const void* dy, const void* b, const void* b_scales, void* dx, void* ws,
    int M, int N, int K, int b_stride, int bn, int w, int bm, int splits,
    int tiles_per_split, int block, int fmt, int fast, void* stream) {
  if (w < 1 || w > 64 || bn % w || N % bn || K % block ||
      (fmt == 4 && K % 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TcArgs p = {};
  p.a = static_cast<const uint8_t*>(dy);
  p.b = static_cast<const uint8_t*>(b);
  p.bs = static_cast<const uint8_t*>(b_scales);
  p.out = dx;
  p.ws = static_cast<float*>(ws);
  p.M = M; p.N = K; p.K = N;
  p.a_stride = N * 4; p.b_stride = b_stride;
  p.nb = K / block;
  p.block = block; p.fmt = fmt; p.bk = bn; p.w = w;
  p.k_tiles = N / bn;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  const int m_tiles = (M + bm - 1) / bm;
  const int col_tiles = (K + kDgCols - 1) / kDgCols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  // bit 0: W's vector decode (the plan's); bit 1: dy's 16-byte reads;
  // bit 2: both, and E8M0 rows of 16-byte multiples: fixed-chunk copies
  fast = (fast ? 1 : 0) | (N % 4 == 0 && w % 4 == 0 ? 2 : 0);
  if (fast == 3 && p.nb % 16 == 0) fast |= 4;
  const bool full = w == 64;
  if (bm == 16) {
    err = full ? launch_dgrad<16, true>(p, fast, m_tiles, col_tiles, s)
               : launch_dgrad<16, false>(p, fast, m_tiles, col_tiles, s);
  } else if (bm == 64) {
    err = full ? launch_dgrad<64, true>(p, fast, m_tiles, col_tiles, s)
               : launch_dgrad<64, false>(p, fast, m_tiles, col_tiles, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || splits <= 1) return err;
  const long long count = static_cast<long long>(M) * K;
  const long long want = (count + 255) / 256;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  mx_matmul_reduce_kernel<<<grid, 256, 0, s>>>(p.ws, dx, count, splits, 0);
  return static_cast<int>(cudaGetLastError());
}
