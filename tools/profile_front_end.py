"""The serving front end on the card: what serving through HTTP/SSE costs
beside the engine's own loop.

    PYTHONPATH=src python3 tools/profile_front_end.py [--rounds N]

granite-8b at full width, ``chip_smoke.py`` phase 4's workload (eight
prompts, two sharing a 64-token head, 32 new tokens, the ragged step),
served in turn on fresh engines over one set of weights: directly
(``engine.submit`` then ``engine.run``), through the server
(``chip_smoke.http_run``: eight concurrent SSE clients on 127.0.0.1),
through the server again, directly again; N rounds (default 2). Each
run prints its tokens/s, the median wall time of an ``engine.step()``
call and of its model dispatch, and for the server runs the host time a
step spends outside ``engine.step()``, the client-side time to first
token, the engine's admission latency and each token's delivery lag
from the engine's recording to its client's receipt (p50, max). The
spread across rounds is the noise a difference must beat.

Needs a CUDA card and ``nvcc`` (the kernels build at first use).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

NEW_TOKENS = 32


def direct_run(engine, prompts) -> dict:
    walls = []
    step = engine.step

    def timed_step():
        t = time.perf_counter()
        try:
            return step()
        finally:
            walls.append(time.perf_counter() - t)

    engine.step = timed_step
    t0 = time.perf_counter()
    ids = [engine.submit(p, NEW_TOKENS) for p in prompts]
    out = engine.run()
    seconds = time.perf_counter() - t0
    engine.step = step
    generated = sum(len(out[i]) - len(p) for i, p in zip(ids, prompts))
    return {"tokens_per_s": generated / seconds,
            "step_call_ms": 1e3 * statistics.median(walls),
            "dispatch_ms": 1e3 * statistics.median(engine.step_seconds),
            "admission_p50_s":
                engine.cache_stats()["admission_latency_p50"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_front_end: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.launch import serve

    cs.log(cs.gpu_name_and_power())
    args = serve.parse_args(cs.FULL_ARGV + ["--new-tokens", str(NEW_TOKENS)])
    params = None
    for r in range(opts.rounds):
        for kind in ("direct", "server", "server", "direct"):
            cfg, engine = serve.build_engine(args, params)
            params = engine.params
            prompts = serve.make_prompts(cfg, args, sharing=2)
            engine.warmup()
            if kind == "direct":
                got = direct_run(engine, prompts)
                cs.log(f"round {r} direct: {got['tokens_per_s']:.1f} tok/s; "
                       f"engine.step() {got['step_call_ms']:.2f} ms, model "
                       f"dispatch {got['dispatch_ms']:.2f} ms (medians); "
                       f"admission latency p50 "
                       f"{got['admission_p50_s'] * 1e3:.1f} ms")
            else:
                got = cs.http_run(engine, prompts, NEW_TOKENS)
                cs.log(f"round {r} server: {got['tokens_per_s']:.1f} tok/s; "
                       f"engine.step() {got['step_call_ms']:.2f} ms, model "
                       f"dispatch {got['dispatch_ms']:.2f} ms (medians), "
                       f"{got['outside_steps_ms']:.2f} ms a step outside "
                       f"engine.step(); client-side time to first token p50 "
                       f"{got['ttft_p50_s'] * 1e3:.1f} ms, max "
                       f"{got['ttft_max_s'] * 1e3:.1f} ms (admission latency "
                       f"p50 {got['admission_p50_s'] * 1e3:.1f} ms); delivery"
                       f" lag p50 {got['lag_p50_s'] * 1e3:.1f} ms, max "
                       f"{got['lag_max_s'] * 1e3:.1f} ms")
            del engine
    return 0


if __name__ == "__main__":
    sys.exit(main())
