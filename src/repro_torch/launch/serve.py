"""Serving launcher: the continuous engine's batch workload on one device
(port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --batch 8 --prompt-len 236 --shared-prefix 64 --ragged --new-tokens 32

Weights are random (a seeded ``torch.Generator``), weight-only MXFP8 with
an MX fp8 KV cache: the reference launcher's ``--quant mxfp8
--quantize-kv`` serving path. Runs on the card unless ``--device cpu``.
The reference's other flags (the HTTP server, sampling, speculation,
tiering, the mesh, other engines and step modes) are not ported yet and
exit with an error naming ROADMAP.md.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.nn import model
from repro_torch.serve import ServeConfig, ServeEngine

log = logging.getLogger("repro_torch.serve")

#: flags of the reference launcher that this port does not take yet
UNPORTED_FLAGS = (
    "--temperature", "--top-p", "--top-k", "--seed", "--slo-ms",
    "--max-queue", "--serve", "--host", "--port", "--prefix-snapshot",
    "--quant", "--quantize-kv", "--engine", "--max-slots", "--page-size",
    "--no-prefix-cache", "--decode-kernel", "--prefill-mode",
    "--prefill-chunk", "--prefill-token-budget", "--tiered",
    "--tier-mid-fmt", "--tier-cold-fmt", "--tier-hot-steps",
    "--tier-cold-steps", "--tier-repack-pages", "--step-mode",
    "--prefill-max-chunks", "--mesh", "--spec-decode", "--num-draft-tokens")


def build_engine(args) -> tuple:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(quant=cfg.quant.replace(quantize_acts=False,
                                              quantize_kv_cache=True))
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(cfg, gen, device)
    max_seq = args.shared_prefix + args.prompt_len + args.new_tokens
    serve_cfg = ServeConfig(max_seq=max_seq, max_slots=args.batch)
    return cfg, ServeEngine(params, cfg, serve_cfg, device=device)


def make_prompts(cfg, args, sharing=None) -> list:
    """The batch workload's prompts, drawn as the reference launcher draws
    them. The ``--shared-prefix`` head leads the first ``sharing``
    prompts (default: all of them, as in the reference)."""
    rng = np.random.default_rng(0)
    lens = (rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1,
                         size=args.batch)
            if args.ragged else [args.prompt_len] * args.batch)
    head = rng.integers(0, cfg.vocab_size,
                        size=(args.shared_prefix,)).astype(np.int32)
    sharing = args.batch if sharing is None else sharing
    return [np.concatenate([head[:args.shared_prefix * (i < sharing)],
                            rng.integers(0, cfg.vocab_size, size=(int(s),))
                            .astype(np.int32)])
            for i, s in enumerate(lens)]


def run_batch(engine, cfg, args, prompts=None) -> dict:
    """Submit the batch workload (``make_prompts`` unless ``prompts`` is
    given), serve it to the end, and report."""
    if prompts is None:
        prompts = make_prompts(cfg, args)
    t0 = time.perf_counter()
    ids = [engine.submit(p, args.new_tokens) for p in prompts]
    results = engine.run()
    dt = time.perf_counter() - t0
    generated = sum(len(results[i]) - len(p) for i, p in zip(ids, prompts))
    stats = engine.cache_stats()
    report = {
        "requests": len(ids), "seconds": dt,
        "generated_tokens": generated, "tokens_per_s": generated / dt,
        "median_step_ms": 1e3 * float(np.median(engine.step_seconds)),
        "ragged_steps": stats["ragged_steps"],
        "kernel_launches": stats["kernel_launches"],
        "preemptions": stats["preemptions"],
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "peak_pages": stats["peak_pages"],
        "prompts": prompts, "ids": ids, "results": results,
    }
    log.info("served %d requests in %.2fs (%.1f tok/s); %d ragged steps "
             "(median %.1f ms), %d kernel launches, %d preemptions, prefix "
             "hit rate %.2f", len(ids), dt, report["tokens_per_s"],
             report["ragged_steps"], report["median_step_ms"],
             report["kernel_launches"], report["preemptions"],
             report["prefix_hit_rate"])
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests, and decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of common prompt head across requests "
                         "(exercises the prefix cache)")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported to repro_torch yet: its "
                     "launcher serves weight-only MXFP8 with an MX fp8 KV "
                     "cache, greedy, with the ServeConfig defaults (see "
                     "ROADMAP.md, section A)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg, engine = build_engine(args)
    engine.warmup()
    return run_batch(engine, cfg, args)


if __name__ == "__main__":
    main()
