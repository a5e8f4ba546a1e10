"""The sampler and the speculative step on the card: where their time goes.

    PYTHONPATH=src python3 tools/profile_sampler.py [--no-alone] [--serve]
        [--rounds N]

  * the sampler alone (``serve.sampling``) at the main path's shapes,
    f32 logits with ``chip_smoke.SAMPLING``'s filters: ``sample`` over
    (8, 49152) and ``verify_rejection`` over (8, 5, 49152), each timed
    (median of 10 CUDA-event runs, ``chip_smoke.cuda_ms``), then traced
    by torch.profiler over 3 calls (``chip_smoke.time_sampler_calls``):
    kernel time in all and by kernel, and the host wall clock of a call;
  * ``--serve``: granite-8b at full width, ``chip_smoke.py`` phase 4's
    workload, greedy and sampled, speculation off and on (n-gram, K 4):
    once every request is decoding, torch.profiler over 4 engine steps:
    the host wall clock of a step, the device busy time of a step, the
    sampler's elapsed time (CUDA events around each sampling call, logits
    to tokens on the host, host gaps included) and the kernels that take
    the most time;
  * ``--rounds N``: the same workload served untouched (no profiler, no
    timer around the sampler), N rounds of five runs in turn on fresh
    engines over one set of weights: greedy; greedy speculation with
    n-gram drafts and with replayed drafts (the greedy run's streams,
    ``chip_smoke.replay_drafter``); sampled, speculation off and on. Each
    run's tokens/s, median and mean step ms, and tokens a verify row:
    the spread across rounds is the noise a difference must beat.

Needs a CUDA card and ``nvcc`` (the kernels build at first use).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 4


def top(kernels: dict, n: int = 8) -> str:
    return "; ".join(f"{name[:70]} ({k:g} x, {ms:.3f} ms)" for name, (k, ms)
                     in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n])


def sampler_alone() -> None:
    vocab = cs.granite_serving_config().vocab_size
    got = cs.time_sampler_calls(vocab)
    for name in cs.sampler_calls(vocab):
        cs.log(f"{name} alone: {got[f'{name}_ms']:.4f} ms (CUDA events, "
               f"median of 10); traced: host {got[f'{name}_host_ms']:.3f} ms "
               f"a call, kernels {got[f'{name}_kernel_ms']:.3f} ms in "
               f"{got[f'{name}_launches']:g} launches; most time: "
               f"{top(got[f'{name}_kernels'])}")


def serve_modes() -> None:
    from repro_torch.launch import serve

    params = None
    base = cs.FULL_ARGV + ["--new-tokens", "32"]
    for title, extra in (("greedy", []), ("greedy spec", cs.SPEC_ARGV),
                         ("sampled", cs.SAMPLE_ARGV),
                         ("sampled spec", cs.SAMPLE_ARGV + cs.SPEC_ARGV)):
        args = serve.parse_args(base + extra)
        cfg, engine = serve.build_engine(args, params)
        params = engine.params
        engine.warmup()
        for p in serve.make_prompts(cfg, args, sharing=2):
            engine.submit(p, args.new_tokens)
        while engine.scheduler.queue or engine.scheduler.prefilling():
            engine.step()
        events = cs.time_sampler(engine)
        engine.step()  # untraced
        del events[:]
        host_ms, busy, kernels = cs.trace_calls(engine.step, STEPS)
        sampler = sum(s.elapsed_time(e) for _, s, e in events) / STEPS
        stats = engine.cache_stats()
        cs.log(f"{title}, decode steps at full width (torch.profiler over "
               f"{STEPS} steps): host {host_ms:.2f} ms a step, device busy "
               f"{busy:.2f} ms (idle {100 * (1 - busy / host_ms):.0f}%), "
               f"sampler {sampler:.3f} ms elapsed a step (CUDA events, "
               f"host gaps included); tokens a verify row "
               f"{stats.get('accepted_per_step', 1.0):.2f}; most time: "
               f"{top(kernels, 6)}")
        engine.run()
        del engine


def serve_rounds(rounds: int) -> None:
    from repro_torch.launch import serve

    params = None
    base = cs.FULL_ARGV + ["--new-tokens", "32"]
    modes = (("greedy", [], None), ("greedy spec ngram", cs.SPEC_ARGV, None),
             ("greedy spec replay", cs.SPEC_ARGV, "replay"),
             ("sampled", cs.SAMPLE_ARGV, None),
             ("sampled spec", cs.SAMPLE_ARGV + cs.SPEC_ARGV, None))
    streams = None
    for r in range(rounds):
        for title, extra, drafter in modes:
            args = serve.parse_args(base + extra)
            cfg, engine = serve.build_engine(args, params)
            params = engine.params
            if drafter:
                engine.drafter = cs.replay_drafter(streams)
            engine.warmup()
            prompts = serve.make_prompts(cfg, args, sharing=2)
            report = serve.run_batch(engine, cfg, args, prompts)
            if title == "greedy":
                streams = [report["results"][i] for i in report["ids"]]
            steps = list(engine.step_seconds)
            per_row = report.get("spec", {}).get("accepted_per_step", 1.0)
            cs.log(f"round {r} {title}: {report['tokens_per_s']:.1f} tok/s, "
                   f"{len(steps)} steps, median "
                   f"{report['median_step_ms']:.2f} ms, mean "
                   f"{1e3 * sum(steps) / len(steps):.2f} ms; tokens a verify "
                   f"row {per_row:.3f}")
            del engine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-alone", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_sampler: no CUDA device visible")
    cs.log(cs.gpu_name_and_power())
    with torch.inference_mode():
        if not args.no_alone:
            sampler_alone()
        if args.serve:
            serve_modes()
        if args.rounds:
            serve_rounds(args.rounds)


if __name__ == "__main__":
    main()
