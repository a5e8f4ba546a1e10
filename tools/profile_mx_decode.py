"""The split-over-keys decode (#4) at granite-8b shapes, on the card.

    PYTHONPATH=src python3 tools/profile_mx_decode.py

On ``chip_smoke.py`` phase 2d's fp8 e4m3 inputs (B 8, KVH 8, G 4, D 128,
21 and 64 pages of 16 keys) and on their first slot alone (B 1: 8 cells,
where shorter splits would fill more of the card), times
``mx_attention_decode`` (median of 25 CUDA-event runs, the card spun 2 ms
before each) with the split size forced to 16, 32, 48 and 64 keys in turn
(64: ``decode_plan``'s), each beside its largest difference from the plain
version, and splits the B 8 planned call's time between its two kernels
with torch.profiler over 20 calls. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import mx_attention as mxa  # noqa: E402


def median_ms(fn, reps: int = 25) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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
        print("profile_mx_decode: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator().manual_seed(17)
    planned = mxa.decode_plan
    for pages, lens in ((cs.P, cs.DECODE_LENS), (cs.LONG_P, cs.LONG_LENS)):
        inp = cs.pair_inputs("fp8_e4m3", pages, lens, gen)
        t = pages * cs.PS
        cache = mxa.gather_kv_pages(*inp["pools"], inp["table"])
        kpos = torch.arange(t, dtype=torch.int32, device="cuda")[None] \
            .expand(cs.R, t).contiguous()
        pos = inp["lens"] - 1
        kw = dict(fmt_name="fp8_e4m3", block_size=cs.BLOCK)
        for b in (cs.R, 1):
            args = (inp["q"][:b], *(x[:b] for x in cache), kpos[:b],
                    pos[:b])

            def run():
                return mxa.mx_attention_decode(*args, **kw)

            want = mxa.mx_attention_decode_plain(*args, **kw)
            try:
                for chunk in (16, 32, 48, 64):
                    splits = -(-t // chunk)
                    mxa.decode_plan = lambda t_, s=splits, c=chunk: (s, c)
                    label = f"{splits} splits of {chunk} keys"
                    err = float((run() - want).abs().max())
                    print(f"mx_attention_decode B {b}, {pages} pages, "
                          f"{label}: {median_ms(run):.4f} ms, max |kernel - "
                          f"plain| {err:.3g}")
            finally:
                mxa.decode_plan = planned

        def run():
            return mxa.mx_attention_decode(inp["q"], *cache, kpos, pos, **kw)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                print(f"  {pages} pages, {ev.key[:60]}: "
                      f"{ev.device_time_total / ev.count:.3f} us a call "
                      f"({ev.count} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
