"""Where the layer-fused megakernel spends its time, phase by phase, on
the card.

    PYTHONPATH=src python3 tools/profile_mx_megakernel.py [--tree DIR]

Builds a copy of ``csrc/mx_megakernel.cu`` in which CTA 0 stamps the
card's ``%globaltimer`` when the kernel starts and after every
``grid.sync()`` (every CTA has then finished the phase before it), loads
it in place of the real library and runs ``mx_megakernel_step`` on
``chip_smoke.py``'s full-width inputs: granite-8b's 36 layers with seeded
random weights, ROWS (8 rows of 64 tokens) over 21-page tables, fp8 e4m3
pools. It prints, for each phase of a layer -- A1 norm, A2 q/k/v, B walk,
C wo, D1 norm, D2 gate/up, E down -- its milliseconds summed over the 36
layers (median of 5 launches after one warm-up), and the whole launch.
The stamps add a few instructions at each barrier; compare phases, and
time the whole step with ``chip_smoke.py``.

``--tree DIR`` profiles the kernel and wrapper of another checkout's
``src/`` (for example the parent commit unpacked by ``git archive``);
its sources must have the same ``grid.sync()`` structure. The copy finds
its places by exact text anchors: an edit there makes this script stop
with the anchor it misses. Needs a CUDA card and ``nvcc``; the copy goes
to that tree's build directory.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("A1 norm", "A2 q/k/v", "B walk", "C wo", "D1 norm", "D2 gate/up",
          "E down")
MAX_STAMPS = 4096

_STAMP_DEFS = '''
__device__ unsigned long long mk_stamps[%d];

__device__ __forceinline__ void mk_stamp(int& i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
    mk_stamps[i] = t;
  }
  ++i;
}

''' % MAX_STAMPS

_READER = '''
extern "C" int mk_read_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, mk_stamps, sizeof(unsigned long long) * n));
}
'''

# (anchor, replacement, expected count): the stamp counter and its first
# stamp, one stamp after each grid.sync()
EDITS = [
    ("__global__ void __launch_bounds__(kThreads, 1)",
     _STAMP_DEFS + "__global__ void __launch_bounds__(kThreads, 1)", 1),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  int mk_i = 0;\n"
     "  mk_stamp(mk_i);\n", 1),
    ("    grid.sync();\n", "    grid.sync();\n    mk_stamp(mk_i);\n",
     len(PHASES)),
]


def stamped_source(src: str) -> str:
    for anchor, edited, count in EDITS:
        if src.count(anchor) != count:
            raise RuntimeError(f"mx_megakernel.cu changed: {count} anchor(s) "
                               f"{anchor!r} expected, "
                               f"{src.count(anchor)} found")
        src = src.replace(anchor, edited)
    return src + _READER


def build_stamped(build) -> ctypes.CDLL:
    src = stamped_source((build.CSRC / build.SOURCES["mx_megakernel"])
                         .read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "profile_mx_megakernel.cu"
    path.write_text(src)
    lib = build.BUILD_DIR / "libprofile_mx_megakernel.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib))
    lib.mk_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mk_read_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose src/ is profiled")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_mx_megakernel: no CUDA device visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this checkout's src/ first on sys.path

    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import mx_megakernel as mk

    print(f"profiling {Path(mk.__file__).resolve()}")
    print(chip_smoke.gpu_name_and_power())
    stamped = build_stamped(build)
    load = build.load
    build.load = lambda name: stamped if name == "mx_megakernel" \
        else load(name)
    mk._lib = None

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke.granite_serving_config()
    inp = chip_smoke.megakernel_inputs(cfg, torch.Generator().manual_seed(4))
    step = chip_smoke.megakernel_layers(inp["params"], cfg, inp["cache"],
                                        *inp["args"][:4])
    layers = cfg.num_layers
    n = 1 + len(PHASES) * layers
    host = (ctypes.c_uint64 * n)()
    step()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        step()
        torch.cuda.synchronize()
        err = stamped.mk_read_stamps(ctypes.addressof(host), n)
        if err:
            raise RuntimeError(f"mk_read_stamps: cudaError {err}")
        t = [int(v) for v in host]
        runs.append([sum(t[1 + len(PHASES) * li + p] - t[len(PHASES) * li + p]
                         for li in range(layers)) / 1e6
                     for p in range(len(PHASES))] + [(t[-1] - t[0]) / 1e6])
    med = [statistics.median(r[i] for r in runs)
           for i in range(len(PHASES) + 1)]
    for name, ms in zip(PHASES, med):
        print(f"megakernel phase {name}: {ms:.3f} ms over {layers} layers "
              f"({ms / layers:.4f} ms a layer)")
    print(f"megakernel launch, first stamp to last: {med[-1]:.3f} ms "
          f"(median of 5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
