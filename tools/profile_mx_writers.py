"""The MX writers, #7 (page repack) and #6 (quantize), on the card.

    PYTHONPATH=src python3 tools/profile_mx_writers.py [--tree DIR] [--sass]
        [--sweep] [--serve N] [--no-kernels]

Times, on ``chip_smoke.py``'s inputs and timer (median of 25 CUDA-event
runs, the card spun 1 ms before each):

  * one kernel launch of the least work, a 1-element ``add_``: the floor
    of the timer (launch, events), beside which the writers' times read;
  * #7, one engine dispatch of 8 fp8 pages over 36 granite-8b layers to
    fp6 e3m2 (``chip_smoke.time_repack_kernel``);
  * #6 at (512, 4096) and (8, 4096), f32 and bf16, fp8 e4m3 at blocks 8,
    32 and 128, fp6 e3m2 and fp4 e2m1 at block 32: the L2 flushed before
    each run (as phase 5) and warm.

``--sweep`` also builds throwaway copies of the two kernels with other
constants (the quantizer's run length, kMaxRun 1-4, and warps aimed at
per SM, 32 or 64; the repack's threads a CTA, 128-512) and times each
the same way, the quantizer's bytes checked against the plain version.
``--serve N`` serves phase 4's tiered run N times, a fresh engine each,
untouched (no timer around its repack calls; ``chip_smoke.py`` phase 4
times those), and prints each run's tokens/s, median step and repack
launches; ``--no-kernels`` skips the kernel timings. Alternate trees
across calls (parent, change, change, parent, ...) to compare the two.
``--tree DIR`` times another checkout's kernels (e.g. the parent commit
unpacked by ``git archive`` into the gitignored ``scratch/``) with that
checkout's ``chip_smoke.py``. ``--sass`` adds, from ``cuobjdump``, the
instructions of the repack's quad loop (fp8 e4m3 -> fp6 e3m2: four
elements a thread an iteration) and of one 128-element group of the
quantizer (f32, fp8 e4m3, 16-byte loads: four elements a lane), which
PERF.md weighs against the bytes. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path


def loop_bodies(text: str) -> tuple:
    """([(address, instruction)] of a ``cuobjdump`` listing of one
    function, [(first, last, [instructions])] of its backward branches'
    loops)."""
    ins = []
    for line in text.splitlines():
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, op in ins:
        m = re.search(r"BRA (?:\S+, )?(?:`\(\S+\) )?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            loops.append((lo, addr, [o for a, o in ins if lo <= a <= addr]))
    return ins, loops


def functions(sass: str) -> dict:
    parts = re.split(r"\n\s*Function : ", sass)
    return {p.split("\n", 1)[0].strip(): p for p in parts[1:]}


def sass_report(cs) -> None:
    fns = functions(cs._sass("mx_repack"))
    body = next(t for n, t in fns.items() if "repack_kernelILi2E" in n)
    _, loops = loop_bodies(body)
    quad = [ops for _, _, ops in loops
            if any("E4M3.UNPACK" in o for o in ops)
            and any("SHFL.DOWN" in o for o in ops)]
    print(f"repack fp8 e4m3 -> fp6 e3m2: quad loop {len(quad[0])} "
          "instructions (static, four elements a thread; skipped branches "
          "included)", flush=True)
    fns = functions(cs._sass("mx_quantize"))
    body = next(t for n, t in fns.items() if "IfLi0ELb1E" in n)
    ins, _ = loop_bodies(body)
    ops = [o for _, o in ins]
    # a 128-element group's reduction starts with the xor-1 shuffle (the
    # one-block-a-group path starts at 16) and ends in its code store
    first = next(i for i, o in enumerate(ops)
                 if "SHFL.BFLY" in o and ", 0x1, " in o)
    store = next(i for i, o in enumerate(ops)
                 if i > first and o.startswith("STG.E "))
    print(f"quantize f32 -> fp8 e4m3, vector loads: {len(ins)} instructions "
          f"in all; a 128-element group's from its first shuffle to its "
          f"code store {store - first + 1} (four elements a lane)",
          flush=True)


def sweep(cs, root: Path) -> None:
    import ctypes
    import tempfile

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import mx_quantize as mq
    from repro_torch.kernels import mx_repack as mr

    csrc = root / "src/repro_torch/kernels/csrc"
    tmp = Path(tempfile.mkdtemp())
    jobs = {}

    def variant(name, src, subs):
        text = (csrc / src).read_text()
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{src}: no {old!r} to vary")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        so = tmp / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(so), str(tmp / f"{name}.cu")]), so)

    quant = [(run, tgt) for run in (1, 2, 4) for tgt in (32, 64)]
    for run, tgt in quant:
        variant(f"q{run}_{tgt}", "mx_quantize.cu", [
            ("constexpr int kMaxRun = 2;", f"constexpr int kMaxRun = {run};"),
            ("const long long target = 32LL * g_sms;",
             f"const long long target = {tgt}LL * g_sms;")])
    for threads in (128, 256, 512):
        variant(f"r{threads}", "mx_repack.cu", [
            ("constexpr int kThreads = 128;",
             f"constexpr int kThreads = {threads};")])
    libs = {}
    for name, (proc, so) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        libs[name] = ctypes.CDLL(str(so))
    gen = torch.Generator("cuda").manual_seed(5)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda").zero_
    xs = [cs._gauss((m, cs.DM), gen) for m in (cs.MX_ROWS, cs.DECODE_ROWS)]
    committed = mq._library()
    for run, tgt in quant:
        lib = libs[f"q{run}_{tgt}"]
        lib.mx_quantize_launch.argtypes = \
            committed.mx_quantize_launch.argtypes
        lib.mx_quantize_launch.restype = committed.mx_quantize_launch.restype
        mq._lib = lib
        parts = []
        for x in xs:
            for inp in (x, x.bfloat16()):
                run_ = lambda: mq.mx_quantize(  # noqa: E731
                    inp, fmt_name="fp8_e4m3", block_size=cs.BLOCK)
                got = run_()
                want = mq.mx_quantize_plain(inp, fmt_name="fp8_e4m3",
                                            block_size=cs.BLOCK)
                if not all(torch.equal(g.view(torch.uint8),
                                       w.view(torch.uint8))
                           for g, w in zip(got, want)):
                    raise AssertionError(f"variant q{run}_{tgt} differs")
                parts.append(f"M {x.shape[0]} {str(inp.dtype)[6:]} "
                             f"{cs.cuda_ms(run_, 25, flush):.4f} / "
                             f"{cs.cuda_ms(run_, 25):.4f}")
        print(f"sweep quantize kMaxRun {run}, {tgt} warps an SM (fp8, block "
              f"{cs.BLOCK}; ms L2 flushed / warm): " + ", ".join(parts),
              flush=True)
    mq._lib = committed
    committed = mr._library()
    for threads in (128, 256, 512):
        lib = libs[f"r{threads}"]
        lib.mx_repack_launch.argtypes = committed.mx_repack_launch.argtypes
        lib.mx_repack_launch.restype = committed.mx_repack_launch.restype
        mr._lib = lib
        print(f"sweep repack, {threads} threads a CTA:", flush=True)
        cs.time_repack_kernel()
    mr._lib = committed


def serve_tiered(cs, tag: str, runs: int) -> None:
    """Phase 4's tiered run (granite-8b at full width, the reference's
    TierPolicy defaults, ``chip_smoke.FULL_ARGV``) ``runs`` times, each on
    a fresh engine, as a user would serve it."""
    import gc

    import torch

    from repro_torch.kernels import mx_repack_pages
    from repro_torch.launch import serve

    args = serve.parse_args(cs.FULL_ARGV + [
        "--new-tokens", str(cs.TIERED_NEW_TOKENS), "--tiered"])
    for i in range(runs):
        cfg, engine = serve.build_engine(args)
        prompts = serve.make_prompts(cfg, args, sharing=2)
        engine.warmup()
        mx_repack_pages.launches = 0
        report = serve.run_batch(engine, cfg, args, prompts)
        torch.cuda.synchronize()
        tiers = report["tiered"]
        print(f"{tag} tiered run {i}: {report['tokens_per_s']:.1f} tok/s, "
              f"median step {report['median_step_ms']:.2f} ms; "
              f"{tiers['repacked_pages']} pages in "
              f"{tiers['repack_dispatches']} dispatches, "
              f"{mx_repack_pages.launches} repack launches", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def time_kernels(cs, tag: str) -> None:
    """The timer's floor, #7's dispatch and #6's cases."""
    import torch

    from repro_torch.kernels import mx_quantize as mq

    tiny = torch.zeros(1, device="cuda")
    print(f"{tag} one 1-element add_: "
          f"{cs.cuda_ms(lambda: tiny.add_(1), 25):.4f} ms", flush=True)
    cs.time_repack_kernel()
    gen = torch.Generator("cuda").manual_seed(5)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda").zero_
    for m in (cs.MX_ROWS, cs.DECODE_ROWS):
        x = cs._gauss((m, cs.DM), gen)
        cases = [("fp8_e4m3", b) for b in (32, 8, 128)] + [
            ("fp6_e3m2", 32), ("fp4_e2m1", 32)]
        for fmt, block in cases:
            for inp in (x, x.bfloat16()):
                run = lambda: mq.mx_quantize(  # noqa: E731
                    inp, fmt_name=fmt, block_size=block)
                run()
                print(f"{tag} quantize {fmt} M={m} K={cs.DM} "
                      f"{str(inp.dtype)[6:]} block {block}: "
                      f"{cs.cuda_ms(run, 25, flush):.4f} ms L2 flushed, "
                      f"{cs.cuda_ms(run, 25):.4f} ms warm", flush=True)



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="N")
    ap.add_argument("--no-kernels", action="store_true")
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("profile_mx_writers: no CUDA device visible", file=sys.stderr)
        return 1
    tag = f"[{root.name}]"
    print(tag, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_all()
    if not args.no_kernels:
        time_kernels(cs, tag)
    if args.sass:
        sass_report(cs)
    if args.sweep:
        sweep(cs, root)
    if args.serve:
        serve_tiered(cs, tag, args.serve)
    return 0


if __name__ == "__main__":
    sys.exit(main())
