// Repack tiered KV pool pages to another MX element format, in place.
//
// Replaces the TPU kernel repro/kernels/mx_repack.py::mx_repack_pages
// (body _repack_kernel, one pallas_call over the grid (N, KVH)). For every
// live list entry n < count and every KV head, for K and for V, it
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
// Design. The TPU grid runs in order, so the reference parks padding
// entries on the last live id and lets them rewrite its bytes harmlessly.
// CTAs on Hopper run at once: a padding CTA that touched the page would
// race the live CTA rewriting it, so one CTA owns one (entry, kv-head) and
// an entry n >= count returns before it reads anything. The repack is in
// place and a narrower output prefix overlaps the input bytes of other
// blocks, so every thread decodes its blocks into shared memory and the
// CTA meets at __syncthreads() before any thread writes. The engine gives
// a page at most once per list, so no two live CTAs share a page row.
//
// What bounds it on an H100 SXM (data-sheet peaks): it reads each page's
// codes and scales once and writes full rows and scales once, a few dozen
// f32 operations per element, so it is bound by bytes. One engine
// dispatch over 8 granite-8b pages (PS 16, KVH 8, D 128) moves ~0.6 MB
// per layer: well under a microsecond at 3.35 TB/s, so each launch costs
// its launch latency. This first version is right and simple (one launch
// per layer pool); chip_smoke.py times a 36-layer dispatch (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_codec.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  uint8_t* e[2];  // K, V elements (NP, PS, KVH, D) full-width rows
  uint8_t* s[2];  // K, V E8M0 scales (NP, PS, KVH, NB)
  const int* page_ids;  // (N,)
  const int* src_fmts;  // (N,)
  int count, NP, KVH, PS, D, BS, NB, dst, mixed_mask, mixed_default;
};

__global__ void __launch_bounds__(kThreads) repack_kernel(const Args a) {
  extern __shared__ float vals[];  // (2, PS, D) decoded K and V
  const int n = blockIdx.x, h = blockIdx.y;
  if (n >= a.count) return;  // padding entry: touches nothing
  // ids clip into the pool, as the reference's wrapper clips them
  const size_t page = static_cast<size_t>(min(max(a.page_ids[n], 0), a.NP - 1));
  const mx::FmtSpec src = mx::fmt_spec(
      mx::mixed_fmt(a.src_fmts[n], a.mixed_mask, a.mixed_default));
  const mx::FmtSpec dst = mx::fmt_spec(a.dst);
  const int tile = a.PS * a.D;

  // 1. decode every element of both tiles before anyone writes
  for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) {
    const int kv = i / tile, r = (i % tile) / a.D, d = i % a.D;
    const size_t prow = (page * a.PS + r) * a.KVH + h;
    const float v = mx::mixed_element_value(a.e[kv] + prow * a.D, d, src);
    const uint8_t e = a.s[kv][prow * a.NB + d / a.BS];
    vals[i] = mx::flush(v * mx::e8m0_factor(e));
  }
  __syncthreads();

  // 2. re-encode one block per job into the row prefix
  const int w = a.D * dst.bits / 8;  // storage_len(D) of the destination
  for (int job = threadIdx.x; job < 2 * a.PS * a.NB; job += blockDim.x) {
    const int kv = job / (a.PS * a.NB), r = (job / a.NB) % a.PS,
              b = job % a.NB;
    const size_t prow = (page * a.PS + r) * a.KVH + h;
    const float* x = vals + kv * tile + r * a.D + b * a.BS;
    mx::encode_block([&](int i) { return x[i]; }, a.BS,
                     a.e[kv] + prow * a.D + b * a.BS * dst.bits / 8,
                     a.s[kv] + prow * a.NB + b, dst);
  }
  // 3. zero the dead tail (disjoint from every prefix byte written above)
  const int tail = a.D - w;
  for (int i = threadIdx.x; i < 2 * a.PS * tail; i += blockDim.x) {
    const int kv = i / (a.PS * tail), r = (i / tail) % a.PS;
    const size_t prow = (page * a.PS + r) * a.KVH + h;
    a.e[kv][prow * a.D + w + i % tail] = 0;
  }
}

}  // namespace

// Launch on `stream` over `n_list` entries; returns the cudaError_t of the
// launch (0 = success). mixed_mask has bit f set for every candidate source
// format id f; ids outside it decode as mixed_default.
extern "C" int mx_repack_launch(void* ke, void* ks, void* ve, void* vs,
                                const void* page_ids, const void* src_fmts,
                                int n_list, int count, int NP, int KVH,
                                int PS, int D, int block_size, int dst_fmt,
                                int mixed_mask, int mixed_default,
                                void* stream) {
  // whole packed bytes per block in every format: block_size % 4 == 0
  if (n_list < 1 || NP < 1 || KVH < 1 || D % block_size != 0 ||
      block_size % 4 != 0 || dst_fmt < 0 || dst_fmt > 4) {
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
  a.dst = dst_fmt;
  a.mixed_mask = mixed_mask;
  a.mixed_default = mixed_default;
  const size_t smem = 2 * static_cast<size_t>(PS) * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      repack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  repack_kernel<<<dim3(n_list, KVH), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
