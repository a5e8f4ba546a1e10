"""Where the tensor-core dgrad kernel spends its time, on the card.

    PYTHONPATH=src python3 tools/profile_mx_dgrad.py

Builds copies of ``csrc/mx_matmul.cu`` in which one phase of
``mx_dgrad_tc_kernel``'s stage loop is skipped (the products, W's decode,
dy's decode, both decodes, the steady-state copies, two of dy's three
terms, the wait at each bn tile's end) or the fixed-chunk copies give way
to the general ``copy_rows`` ones, loads each in place of the real library
and times ``mx_matmul_dgrad`` at granite-8b's gate/up projection (dy (M,
14336) f32 at M 512 and 8, W (14336, 4096) fp8 e4m3, block 32, bn 128;
median of 9 CUDA-event runs, L2 flushed and the card spun 2 ms before
each). A phase's
share is the whole kernel's time less the copy's without it; the copies
compute wrong values, so compare times only. The variants find their
places by exact text anchors in the stage loop: an edit there makes this
script stop with the anchor it misses. Needs a CUDA card and ``nvcc``; the
copies go to the build directory.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from repro_torch.core import quantize
from repro_torch.kernels import build
from repro_torch.kernels import mx_matmul as mm

_PRODUCTS = [
    ("          if (term == 0) {\n            wgmma_bf16<BM / 2, 1>(acc,",
     "          if (term == 0 && p.K < 0) {\n"
     "            wgmma_bf16<BM / 2, 1>(acc,"),
    ("            wgmma_bf16<BM / 2, 1>(acc2, dw",
     "            if (p.K < 0) wgmma_bf16<BM / 2, 1>(acc2, dw")]
_W_DECODE = [("    decode_dgrad_w(p, f, fast & 1, s0, c0,",
              "    if (p.K < 0) decode_dgrad_w(p, f, fast & 1, s0, c0,")]
_DY_DECODE = [
    ("    if (fast & 2) {\n      decode_dy_vec",
     "    if (p.K < 0) {\n    } else if (fast & 2) {\n      decode_dy_vec"),
    ("    } else {\n      decode_wide<BM, true>(p, s0, st + L::kA, m0,",
     "    } else if (p.K < 0) {\n      decode_wide<BM, true>(p, s0, "
     "st + L::kA, m0,")]
# (label, the edits); a condition the compiler cannot fold skips a phase
VARIANTS = [
    ("whole kernel", []),
    ("without the products", _PRODUCTS),
    ("without W's decode", _W_DECODE),
    ("without dy's decode", _DY_DECODE),
    ("without both decodes", _W_DECODE + _DY_DECODE),
    ("without the steady-state copies",
     [("    if (j < nst) issue(j,", "    if (j < nst && p.K < 0) issue(j,")]),
    ("with one of dy's three terms",
     [("        for (int term = 0; term < 3; ++term) {\n"
       "          const uint64_t da = sw128_desc(",
       "        for (int term = 0; term < 1; ++term) {\n"
       "          const uint64_t da = sw128_desc(")]),
    ("with copy_rows in place of the fixed-chunk copies",
     [("    if (fast & 4) {\n      issue_dgrad_stage_rows",
       "    if ((fast & 4) && p.K < 0) {\n      issue_dgrad_stage_rows")]),
    ("without the wait at each bn tile's end",
     [("    if ((i + 1) % per_tile != 0) {\n      // stage i's",
       "    if (p.K > 0) {\n      // stage i's")]),
]


def variant_source(edits) -> str:
    src = (build.CSRC / build.SOURCES["mx_matmul"]).read_text()
    for anchor, edited in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"mx_matmul.cu changed; no single anchor "
                               f"{anchor!r}")
        src = src.replace(anchor, edited)
    return src


def build_variants() -> list:
    """One nvcc per variant, all at once; returns [(label, library)]."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (label, edits) in enumerate(VARIANTS):
        src = build.BUILD_DIR / f"profile_mx_dgrad_{i}.cu"
        src.write_text(variant_source(edits))
        lib = build.BUILD_DIR / f"libprofile_mx_dgrad_{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(lib), str(src)]
        jobs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs.append((label, ctypes.CDLL(str(lib))))
    return libs


def median_ms(fn, scratch: torch.Tensor, reps: int = 9) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        scratch.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mx_dgrad: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build_variants()
    gen = torch.Generator("cuda").manual_seed(0)
    k, n = 4096, 14336
    w = quantize(torch.randn(k, n, generator=gen, device="cuda") / 64,
                 "fp8_e4m3", 32, axis=0)
    dys = [torch.randn(m, n, generator=gen, device="cuda") for m in (512, 8)]
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    saved = mm._lib
    try:
        for label, lib in libs:
            lib.mx_matmul_dgrad_launch.argtypes = [p] * 5 + [i] * 12 + [p]
            lib.mx_matmul_dgrad_launch.restype = ctypes.c_int
            mm._lib = lib
            for dy in dys:
                ms = median_ms(lambda: mm.mx_matmul_dgrad(
                    dy, w.elements, w.scales, bn=128), scratch)
                print(f"mx_matmul_dgrad gate/up M={dy.shape[0]} fp8_e4m3, "
                      f"{label}: {ms:.4f} ms")
    finally:
        mm._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
