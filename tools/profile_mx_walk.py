"""Where the ragged kernel's page walk spends its time, on the card.

    PYTHONPATH=src python3 tools/profile_mx_walk.py

Builds copies of ``csrc/mx_attention_ragged.cu`` (with its headers) in
which one part of the cell is skipped or cut -- every cell walking only
its last page, the new rows' quantized writes, the output stores, the
fold of each page into the softmax (decode and loads stay), the P.V
multiply-adds, the whole P.V -- loads each in place of the real library
and times ``mx_attention_ragged_fused`` on ``chip_smoke.py``'s ROWS (8
rows, W 64, granite-8b's attention, 21-page tables, fp8 e4m3 pools;
median of 25 CUDA-event runs after the card spins 1 ms). A part's share
is the whole kernel's time less the copy's without it; the copies
compute wrong values, so compare times only. The copies find their
places by exact text anchors: an edit there makes this script stop with
the anchor it misses. Needs a CUDA card and ``nvcc``; the copies go to
the build directory.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# (label, edits); a condition the compiler cannot fold skips a part
_ONE_PAGE = ("  if (first >= valid) return;\n",
             "  if (first >= valid) return;\n"
             "  first = max(first, valid - 1);\n")
VARIANTS = [
    ("whole kernel", []),
    ("every cell walking its last page only", [_ONE_PAGE]),
    ("last page only, without the quantized writes", [
        _ONE_PAGE, ("const int njobs = max(0, t1 - t0) * 2 * P.NB;",
                    "const int njobs = P.D < 0 ? max(0, t1 - t0) : 0;")]),
    ("last page only, without the output stores", [
        _ONE_PAGE, ("    mxwalk::walk_finish(w, [&](int i, float4 v) {",
                    "    if (P.D < 0) mxwalk::walk_finish(w, [&](int i, "
                    "float4 v) {")]),
    ("without folding the pages (decode and loads stay)", [
        ("  auto fold = [&](int p) {\n",
         "  auto fold = [&](int p) {\n    if (P.D > 0) return;\n")]),
    ("without the P.V multiply-adds", [
        ("          if (q0 + q < groups) {\n            const float4 v4",
         "          if (q0 + q < groups && D < 0) {\n"
         "            const float4 v4")]),
    ("without P.V (its loads, sums and accumulator updates)", [
        ("    for (int q0 = 0; q0 < groups; q0 += 2) {",
         "    for (int q0 = 0; q0 < groups && D < 0; q0 += 2) {")]),
]


def build_variants(build) -> list:
    """One nvcc per variant, all at once; returns [(label, library)]."""
    jobs = []
    for i, (label, edits) in enumerate(VARIANTS):
        d = build.BUILD_DIR / f"profile_mx_walk_{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for anchor, edited in edits:
            hits = [f for f in sorted(d.glob("*.cu*"))
                    if f.read_text().count(anchor) == 1]
            if len(hits) != 1:
                raise RuntimeError(f"the walk changed; no single anchor "
                                   f"{anchor!r}")
            hits[0].write_text(hits[0].read_text().replace(anchor, edited))
        lib = d / "lib.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(d / build.SOURCES["mx_attention_ragged"])]
        jobs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs.append((label, ctypes.CDLL(str(lib))))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mx_walk: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first on sys.path
    from repro_torch.kernels import build
    from repro_torch.kernels import mx_attention as mxa

    print(cs.gpu_name_and_power())
    libs = build_variants(build)
    inp = cs.ragged_inputs("fp8_e4m3", torch.Generator().manual_seed(0))
    pools = [t.clone() for t in inp["pools"]]
    load = build.load
    try:
        for label, lib in libs:
            build.load = lambda name, lib=lib: (
                lib if name == "mx_attention_ragged" else load(name))
            mxa._libs.pop("mx_attention_ragged", None)
            call = lambda: mxa.mx_attention_ragged_fused(  # noqa: E731
                *cs._call_args(inp, pools), block_size=cs.BLOCK)
            for _ in range(3):
                call()
            print(f"mx_attention_ragged_fused ROWS fp8_e4m3, {label}: "
                  f"{cs.cuda_ms(call, 25):.4f} ms")
    finally:
        build.load = load
        mxa._libs.pop("mx_attention_ragged", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
