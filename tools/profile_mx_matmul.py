"""Where a stage of the tensor-core MX matmul spends its cycles, on the card.

    PYTHONPATH=src python3 tools/profile_mx_matmul.py

Builds a copy of ``csrc/mx_matmul.cu`` with ``clock64`` counters around the
phases of ``mx_matmul_tc_kernel``'s stage loop (the previous stage's product
wait and the next copies' issue; the copy wait and the first barrier; the
decode into the bf16 tiles; the proxy fence and the second barrier; the
product issue), and a second copy whose products are skipped. Each is
loaded in place of the real library for one call of ``mx_matmul_wo`` (bf16
A) and ``mx_matmul_vv`` at granite-8b's gate/up projection (K 4096, N
14336, fp8 e4m3, block 32), M 512 and M 8, and prints the mean cycles of a
stage by phase, read by warpgroup 0 and 1's first threads. The counters
and their atomics slow the kernel; compare phases, not the kernel's time.
The probes find their places by exact text anchors in the stage loop: an
edit there makes this script stop with the anchor it misses. Needs a CUDA
card and ``nvcc``; the copies go to the build directory. (The SASS counts
of the kernels are phase 5 of ``chip_smoke.py``.)
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.core import quantize
from repro_torch.kernels import build
from repro_torch.kernels import mx_matmul as mm

PHASES = ("previous wait + copy issue", "copy wait + barrier", "decode",
          "fence + barrier", "product issue")

_COUNTERS = '''
__device__ unsigned long long g_prof[8];
'''
_READERS = '''
extern "C" int prof_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
extern "C" int prof_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''

# (anchor in the stage loop, the same text with a counter read around it)
_PROBES = [
    ("  for (int i = 0; i < nst; ++i) {\n"
     "    const int j = i + L::kStages - 1;\n",
     "  long long tA = clock64();\n  for (int i = 0; i < nst; ++i) {\n"
     "    const int j = i + L::kStages - 1;\n"),
    ("    if constexpr (LEAN) {\n      mbar_wait(",
     "    long long c0 = clock64();\n    if constexpr (LEAN) {\n"
     "      mbar_wait("),
    ("    __syncthreads();\n    const int k0 = kbase + i * p.w;",
     "    __syncthreads();\n    long long c1 = clock64();\n"
     "    const int k0 = kbase + i * p.w;"),
    ("    fence_proxy_async();\n    __syncthreads();\n\n",
     "    long long c2 = clock64();\n    fence_proxy_async();\n"
     "    __syncthreads();\n    long long c3 = clock64();\n\n"),
    ("    wgmma_commit();\n    const bool tile_end",
     "    wgmma_commit();\n    long long c4 = clock64();\n"
     "    if (threadIdx.x == 0 || threadIdx.x == 128) {\n"
     "      atomicAdd(&g_prof[0], (unsigned long long)(c0 - tA));\n"
     "      atomicAdd(&g_prof[1], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&g_prof[2], (unsigned long long)(c2 - c1));\n"
     "      atomicAdd(&g_prof[3], (unsigned long long)(c3 - c2));\n"
     "      atomicAdd(&g_prof[4], (unsigned long long)(c4 - c3));\n"
     "      atomicAdd(&g_prof[7], 1ull);\n    }\n    tA = c4;\n"
     "    const bool tile_end"),
]
# the products skipped (a condition the compiler cannot fold)
_NO_PRODUCTS = (
    "          if (term == 0) {\n            wgmma_bf16<BM / 2>(acc,",
    "          if (term == 0 && p.K < 0) {\n"
    "            wgmma_bf16<BM / 2>(acc,")


def instrumented_source(products: bool = True) -> str:
    src = (build.CSRC / build.SOURCES["mx_matmul"]).read_text()
    probes = _PROBES + ([] if products else [_NO_PRODUCTS])
    for anchor, probed in probes:
        if src.count(anchor) != 1:
            raise RuntimeError(f"mx_matmul.cu changed; no single anchor "
                               f"{anchor!r}")
        src = src.replace(anchor, probed)
    return src.replace("struct TcArgs {",
                       _COUNTERS + "struct TcArgs {") + _READERS


def load_instrumented(products: bool = True) -> ctypes.CDLL:
    name = "profile_mx_matmul" + ("" if products else "_no_products")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}.cu"
    src.write_text(instrumented_source(products))
    lib = build.BUILD_DIR / f"lib{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def profile(lib: ctypes.CDLL, label: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mx_matmul_tc_launch.argtypes = [p, p, i, p, p, p, p] + [i] * 15 + [p]
    lib.mx_matmul_tc_launch.restype = ctypes.c_int
    saved, mm._lib = mm._lib, lib
    try:
        k, n = 4096, 14336
        gen = torch.Generator("cuda").manual_seed(0)
        w = quantize(torch.randn(k, n, generator=gen, device="cuda") / 64,
                     "fp8_e4m3", 32, axis=0)
        for m in (512, 8):
            x = torch.randn(m, k, generator=gen, device="cuda")
            xq = quantize(x, "fp8_e4m3", 32)
            kw = dict(fmt_name="fp8_e4m3", block_size=32, bk=512)
            calls = {
                "wo": lambda: mm.mx_matmul_wo(x.bfloat16(), w.elements,
                                              w.scales, **kw),
                "vv": lambda: mm.mx_matmul_vv(xq.elements, xq.scales,
                                              w.elements, w.scales, **kw)}
            for kernel, call in calls.items():
                call()
                torch.cuda.synchronize()
                lib.prof_reset()
                call()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 8)()
                lib.prof_read(buf)
                stages = max(buf[7], 1)
                split = ", ".join(f"{ph} {buf[j] / stages:.0f}"
                                  for j, ph in enumerate(PHASES))
                print(f"{label} {kernel} M={m}: cycles a stage: {split}; "
                      f"total {sum(buf[:5]) / stages:.0f}")
    finally:
        mm._lib = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mx_matmul: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    profile(load_instrumented(True), "kernel")
    profile(load_instrumented(False), "without products")
    return 0


if __name__ == "__main__":
    sys.exit(main())
