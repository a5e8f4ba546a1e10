// Repack tiered KV pool pages to another MX element format, in place.
//
// Replaces the TPU kernel repro/kernels/mx_repack.py::mx_repack_pages
// (body _repack_kernel, one pallas_call over the grid (N, KVH)). For every
// layer, every live list entry n < count and every KV head, for K and for
// V, it
//   1. reads the page's PS full-width uint8 rows and decodes their prefix
//      under the page's source format src_fmts[n] (fp8 from D bytes, fp6
//      from 3D/4, fp4 from D/2), folds the E8M0 scales and flushes
//      subnormal results (the reference's _dequant_rows_mixed);
//   2. re-encodes every block to the destination format with a fresh
//      E8M0 scale (block amax -> floor-log2 -> e > 0 test -> clip -> RNE
//      -> pack, the reference's _quantize_rows, through the mx_codec.cuh
//      functions every writing kernel of the port calls);
//   3. writes the codes into the row prefix and zeroes the dead tail bytes
//      [storage_len(D), D). The destination may be wider than the source
//      (fp8 after a copy-on-write promotion).
//
// Design. One launch covers a whole engine dispatch: the grid runs over
// (KV head, list entry, layer) of layer-stacked pools (L, NP, PS, KVH, D)
// (a per-layer pool is L = 1). The TPU grid runs in order, so the
// reference parks padding entries on the last live id and lets them
// rewrite its bytes harmlessly; CTAs on Hopper run at once, so one CTA
// owns one (layer, entry, head) and an entry n >= count returns before it
// reads anything. The repack is in place and a narrower output prefix
// overlaps the input bytes of other blocks, so the CTA first copies its
// tile's source codes and scales into shared memory (16-byte row loads)
// and meets at __syncthreads() before any thread writes. The engine lists
// a page at most once, so no two live CTAs share a page row.
//
// Then a thread owns four consecutive elements of a row (a quad) at a
// time, stepping through the tile without a divide: it decodes them (fp8
// by the hardware's e4m3x2/e5m2x2 conversion; the NaN/inf codes that
// conversion misreads take the reference's arithmetic decode out of
// line), folds the scale with a flushing multiply, takes the block amax in
// the thread and across the block's lanes with xor shuffles, scales by the
// exact reciprocal 2^(127-e) (x / 2^(e-127) rounds the same real value
// once), encodes (mx_codec.cuh: fp8 by fp8_pair, the hardware's RNE
// conversion; fp6 and fp4 by encode, RNE on the f32 bits) and packs the
// four codes into 32, 24 or 16 bits. Neighbouring lanes merge their codes
// with one shuffle so that fp6 (four lanes, three words) and fp4 (two
// lanes, one word) leave in 4-byte stores; fp8 stores its own word. The
// dead tail is zeroed with 16-byte stores. The tile is templated on its
// source and destination formats, so each format's fields are constants.
// A block whose quads do not fill a power-of-two group of at most 32 lanes
// takes its exponent from a pass over shared memory instead.
//
// What bounds it on an H100 SXM (data-sheet peaks): it reads each page's
// source codes and scales once and writes full rows and scales once: one
// engine dispatch over 8 granite-8b pages (PS 16, KVH 8, D 128) in 36
// layers moves 19.5 MB, 5.8 us at 3.35 TB/s. The instructions bound it
// instead: 9.4 M elements a dispatch at a few dozen instructions each
// (decode, amax, ratio, encode, pack, addresses), which tools/
// profile_mx_writers.py counts in the SASS (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  uint8_t* e[2];  // K, V elements (L, NP, PS, KVH, D) full-width rows
  uint8_t* s[2];  // K, V E8M0 scales (L, NP, PS, KVH, NB)
  const int* page_ids;  // (N,)
  const int* src_fmts;  // (N,)
  int count, NP, KVH, PS, D, BS, NB, mixed_mask, mixed_default;
  int rows16;   // element rows start on 16 bytes (D % 16 == 0, aligned)
  int scales4;  // scale rows start on 4 bytes (NB % 4 == 0, aligned)
};

// the reference's arithmetic decode of a word of four fp8 codes, out of
// line: only NaN/inf codes of the hardware conversion (which no encoder
// writes) take this call, so the common path stays short
template <int SRC>
__device__ __noinline__ float4 decode_fp8_fields(uint32_t w) {
  constexpr mx::FmtSpec f = mx::fmt_spec(SRC);
  return make_float4(mx::u8_fp8_value(w & 0xFFu, f),
                     mx::u8_fp8_value((w >> 8) & 0xFFu, f),
                     mx::u8_fp8_value((w >> 16) & 0xFFu, f),
                     mx::u8_fp8_value(w >> 24, f));
}

// four source codes starting at element 4j of a staged row, as values
template <int SRC>
__device__ __forceinline__ void decode_quad(const uint8_t* row, int j,
                                            float* v) {
  constexpr mx::FmtSpec f = mx::fmt_spec(SRC);
  if constexpr (f.bits == 8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * j);
    mx::fp8x4(w, SRC, v);
    // the conversion reads e4m3 0x7F/0xFF as NaN and e5m2's top exponent
    // as inf/NaN; the reference decodes those fields arithmetically
    constexpr uint32_t top = SRC == 0 ? 0x7F7F7F7Fu : 0x7C7C7C7Cu;
    constexpr uint32_t one = SRC == 0 ? 0x01010101u : 0x04040404u;
    if (((w & top) + one) & 0x80808080u) {
      const float4 d = decode_fp8_fields<SRC>(w);
      v[0] = d.x, v[1] = d.y, v[2] = d.z, v[3] = d.w;
    }
  } else if constexpr (f.bits == 6) {
    const uint8_t* b = row + 3 * j;
    const uint32_t w = b[0] | (b[1] << 8) | (b[2] << 16);
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = mx::decode_fp6((w >> (6 * t)) & 63u, f);
  } else {
    const uint8_t* b = row + 2 * j;
    const uint32_t w = b[0] | (b[1] << 8);
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = mx::decode_fp4((w >> (4 * t)) & 15u);
  }
}

// One (layer, entry, head) tile from format SRC to format DST.
template <int SRC, int DST>
__device__ __forceinline__ void repack_tile(const Args& a, uint8_t* smem,
                                            int layer, int page, int h) {
  constexpr mx::FmtSpec src = mx::fmt_spec(SRC), dst = mx::fmt_spec(DST);
  const int rows = 2 * a.PS;  // the K rows, then the V rows
  const int ws = a.D * src.bits / 8, wd = a.D * dst.bits / 8;
  // staged source: codes (rows, ws), then scales (rows, NB), then the
  // exponents of the shared-memory amax pass (rows, NB)
  uint8_t* codes = smem;
  uint8_t* scl = smem + ((rows * ws + 15) & ~15);
  uint8_t* ex = scl + rows * a.NB;
  const size_t page_row = (static_cast<size_t>(layer) * a.NP + page) * a.PS;
  // byte offsets of staged row i's element row and scale row (K rows,
  // then V rows: a select, since an indexed kernel argument would copy
  // the arguments to local memory)
  auto row_of = [&](int i) {
    const int kv = i >= a.PS;
    return (page_row + i - kv * a.PS) * a.KVH + h;
  };
  auto elems = [&](int i) { return i < a.PS ? a.e[0] : a.e[1]; };
  auto scales = [&](int i) { return i < a.PS ? a.s[0] : a.s[1]; };

  // 1. stage the tile's source bytes; every read happens before any write
  const bool wide = a.rows16 && ws % 16 == 0;
  const int units = wide ? ws / 16 : ws;  // 16-byte chunks, or bytes
  for (int c = threadIdx.x; c < rows * units; c += kThreads) {
    const int i = c / units, u = c - i * units;
    const uint8_t* row = elems(i) + row_of(i) * a.D;
    if (wide) {
      reinterpret_cast<uint4*>(codes + i * ws)[u] =
          reinterpret_cast<const uint4*>(row)[u];
    } else {
      codes[i * ws + u] = row[u];
    }
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const uint8_t* s = scales(i) + row_of(i) * a.NB;
    if (a.scales4) {
      for (int c = 0; c < a.NB / 4; ++c) {
        reinterpret_cast<uint32_t*>(scl + i * a.NB)[c] =
            reinterpret_cast<const uint32_t*>(s)[c];
      }
    } else {
      for (int c = 0; c < a.NB; ++c) scl[i * a.NB + c] = s[c];
    }
  }
  __syncthreads();

  const int qpr = a.D / 4;  // quads a row
  const int g = a.BS / 4;   // quads a block
  const bool lanes_reduce = g <= 32 && (g & (g - 1)) == 0;
  if (!lanes_reduce) {  // each block's exponent from the staged bytes
    for (int job = threadIdx.x; job < rows * a.NB; job += kThreads) {
      const int i = job / a.NB, b = job - i * a.NB;
      const float factor = mx::e8m0_factor(scl[job]);
      float amax = 0.0f;
      for (int j = b * g; j < (b + 1) * g; ++j) {
        float v[4];
        decode_quad<SRC>(codes + i * ws, j, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          amax = fmaxf(amax, fabsf(mx::mul_ftz(v[t], factor)));
        }
      }
      ex[job] = mx::e8m0_from_amax(amax, dst);
    }
    __syncthreads();
  }

  // 2. decode, re-encode and store a quad a thread at a time: thread t
  // starts at quad t of the tile (row i, quad j of the row) and steps
  // kThreads quads, carried into (i, j) without a divide
  const bool words = a.rows16;  // 4-byte code stores (D % 16 == 0)
  const int di = kThreads / qpr, dj = kThreads - di * qpr;
  int i = threadIdx.x / qpr, j = threadIdx.x - i * qpr;
  int b = 4 * j / a.BS;
  for (int base = 0; base < rows * qpr; base += kThreads) {
    const bool live = i < rows;
    const int ii = live ? i : 0;
    float v[4];
    decode_quad<SRC>(codes + ii * ws, j, v);
    const float factor = mx::e8m0_factor(scl[ii * a.NB + b]);
    float amax = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // decoded codes are normal f32s: the product flushes as the
      // reference's decode does
      v[t] = live ? mx::mul_ftz(v[t], factor) : 0.0f;
      amax = fmaxf(amax, fabsf(v[t]));
    }
    uint8_t e;
    if (lanes_reduce) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (off < g) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
      }
      e = mx::e8m0_from_amax(amax, dst);
    } else {
      e = ex[ii * a.NB + b];
    }
    const float recip = mx::e8m0_recip(e);
    float r[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      r[t] = fminf(fmaxf(e > 0 ? v[t] * recip : 0.0f, -dst.max), dst.max);
    }
    uint32_t word = 0;
    if constexpr (dst.bits == 8) {
      word = mx::fp8_pair(r[0], r[1], dst) | (mx::fp8_pair(r[2], r[3], dst)
                                              << 16);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        word |= mx::encode(r[t], dst) << (t * dst.bits);
      }
    }
    uint8_t* out = elems(ii) + row_of(ii) * a.D;
    const uint32_t next = __shfl_down_sync(kFull, word, 1);
    if (live) {
      if constexpr (dst.bits == 8) {
        reinterpret_cast<uint32_t*>(out)[j] = word;
      } else if constexpr (dst.bits == 6) {
        const int t = j & 3;  // four quads' 12 bytes leave as 3 words
        if (words) {
          if (t < 3) {
            reinterpret_cast<uint32_t*>(out + 3 * (j - t))[t] =
                (word >> (8 * t)) | (next << (24 - 8 * t));
          }
        } else {
          for (int c = 0; c < 3; ++c) out[3 * j + c] = word >> (8 * c);
        }
      } else if (words) {  // fp4: two quads' 4 bytes as a word
        if ((j & 1) == 0) {
          reinterpret_cast<uint32_t*>(out)[j >> 1] = word | (next << 16);
        }
      } else {
        out[2 * j] = word;
        out[2 * j + 1] = word >> 8;
      }
      if (4 * j == b * a.BS) scales(ii)[row_of(ii) * a.NB + b] = e;
    }
    i += di;
    j += dj;
    if (j >= qpr) j -= qpr, ++i;
    if (dj) b = 4 * j / a.BS;
  }

  // 3. zero the dead tail (disjoint from every prefix byte written above)
  const int tail = a.D - wd;
  const bool wide_tail = a.rows16 && wd % 16 == 0;
  const int tail_units = wide_tail ? tail / 16 : tail;
  for (int c = threadIdx.x; c < rows * tail_units; c += kThreads) {
    const int r = c / tail_units, u = c - r * tail_units;
    uint8_t* row = elems(r) + row_of(r) * a.D + wd;
    if (wide_tail) {
      reinterpret_cast<uint4*>(row)[u] = make_uint4(0, 0, 0, 0);
    } else {
      row[u] = 0;
    }
  }
}

template <int DST>
__global__ void __launch_bounds__(kThreads) repack_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, n = blockIdx.y, layer = blockIdx.z;
  if (n >= a.count) return;  // padding entry: touches nothing
  // ids clip into the pool, as the reference's wrapper clips them
  const int page = min(max(a.page_ids[n], 0), a.NP - 1);
  switch (mx::mixed_fmt(a.src_fmts[n], a.mixed_mask, a.mixed_default)) {
    case 0: repack_tile<0, DST>(a, smem, layer, page, h); break;
    case 1: repack_tile<1, DST>(a, smem, layer, page, h); break;
    case 2: repack_tile<2, DST>(a, smem, layer, page, h); break;
    case 3: repack_tile<3, DST>(a, smem, layer, page, h); break;
    default: repack_tile<4, DST>(a, smem, layer, page, h); break;
  }
}

int g_smem_attr = 48 << 10;  // dynamic shared memory the kernel may use

}  // namespace

// Launch on `stream` over `layers` stacked pools and `n_list` entries;
// returns the cudaError_t of the launch (0 = success). mixed_mask has bit f
// set for every candidate source format id f; ids outside it decode as
// mixed_default.
extern "C" int mx_repack_launch(void* ke, void* ks, void* ve, void* vs,
                                const void* page_ids, const void* src_fmts,
                                int n_list, int count, int layers, int NP,
                                int KVH, int PS, int D, int block_size,
                                int dst_fmt, int mixed_mask,
                                int mixed_default, void* stream) {
  // whole packed bytes per block in every format: block_size % 4 == 0
  if (n_list < 1 || layers < 1 || NP < 1 || KVH < 1 || PS < 1 ||
      block_size < 4 || D % block_size != 0 || block_size % 4 != 0 ||
      dst_fmt < 0 || dst_fmt > 4 || n_list > 65535 || layers > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.e[0] = static_cast<uint8_t*>(ke);
  a.e[1] = static_cast<uint8_t*>(ve);
  a.s[0] = static_cast<uint8_t*>(ks);
  a.s[1] = static_cast<uint8_t*>(vs);
  a.page_ids = static_cast<const int*>(page_ids);
  a.src_fmts = static_cast<const int*>(src_fmts);
  a.count = count;
  a.NP = NP;
  a.KVH = KVH;
  a.PS = PS;
  a.D = D;
  a.BS = block_size;
  a.NB = D / block_size;
  a.mixed_mask = mixed_mask;
  a.mixed_default = mixed_default;
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  a.rows16 = D % 16 == 0 && aligned(ke, 16) && aligned(ve, 16);
  a.scales4 = a.NB % 4 == 0 && aligned(ks, 4) && aligned(vs, 4);
  const int rows = 2 * PS;
  const size_t smem = ((static_cast<size_t>(rows) * D + 15) & ~size_t{15}) +
                      2 * static_cast<size_t>(rows) * a.NB;
  void (*kernels[5])(const Args) = {repack_kernel<0>, repack_kernel<1>,
                                     repack_kernel<2>, repack_kernel<3>,
                                     repack_kernel<4>};
  if (smem > static_cast<size_t>(g_smem_attr)) {  // once, to the card's max
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > static_cast<size_t>(most)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (auto kernel : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    g_smem_attr = most;
  }
  kernels[dst_fmt]<<<dim3(KVH, n_list, layers), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
