"""Serving launcher: the continuous engine's batch workload on one device
(port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --batch 8 --prompt-len 236 --shared-prefix 64 --ragged --new-tokens 32

``--arch`` is any of ``configs.list_archs()``: granite-8b, gemma2-2b,
gemma2-9b (local/global windows, softcaps, GeGLU, post-norms; the
megakernel mode falls back to the ragged step), phi4-mini-3.8b,
mixtral-8x22b (8 experts top-2 behind every layer, window 4096; the
megakernel mode falls back to the ragged step), deepseek-v2-lite-16b
(multi-head latent attention, a dense first layer, then 64 experts top-6
and 2 shared), recurrentgemma-2b (RG-LRU and local attention),
mamba2-780m (SSD), llava-next-mistral-7b (its mistral-7b backbone served
from token ids, as in the reference) and musicgen-medium, at full width
or ``--reduced``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --reduced --batch 4 --prompt-len 20 --shared-prefix 8 --ragged \
      --new-tokens 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --reduced --batch 4 --prompt-len 20 --shared-prefix 8 --ragged \
      --new-tokens 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 8 --prompt-len 236 --shared-prefix 64 --ragged \
      --new-tokens 32 --step-mode megakernel

mixtral-8x22b's 56 layers (~280 GB of prepared weights) do not fit one
card; ``build_engine(args, num_groups=8)`` serves its first 8 at full
width. deepseek-v2-lite-16b's latent cache has no page layout, so it is
served by the fixed-slot engine alone, as in the reference (the default
continuous engine raises with the reference's message); all 27 layers
(~31 GB of bf16 prepared weights) fit one card:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --reduced --engine fixed --batch 4 \
      --prompt-len 24 --new-tokens 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --engine fixed --batch 8 \
      --prompt-len 256 --new-tokens 64

recurrentgemma-2b and mamba2-780m keep per-slot state rows: as in the
reference, the engine turns the prefix cache off, admits each prompt with
one monolithic prefill and decodes through the split step (log lines
say so), and ``--spec-decode`` or ``--tiered`` raise. mamba2's prefill
takes a prompt of at most ``ssd_chunk`` (256) tokens or a multiple of it
(the reference's assertion):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --reduced --batch 4 --prompt-len 20 \
      --ragged --new-tokens 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 8 --prompt-len 256 --ragged --new-tokens 64

musicgen-medium's codebook heads are served by no engine, as in the
reference: the continuous engine raises ``NotImplementedError``
("continuous batching with codebook heads is a follow-on") and
``--engine fixed`` ``ValueError`` (its token prompts are not codebook
frames); ``model.prefill`` and ``model.decode_step`` run it
(``chip_smoke.py`` phase 14b).

Weights are random (a seeded ``torch.Generator``) and weight-only MX. By
default they are MXFP8 with an MX fp8 KV cache, the reference launcher's
``--quant mxfp8 --quantize-kv`` serving path; ``--quant mxfp4
--quantize-kv`` serves fp4 weights and packed fp4 pages, and ``--quant``
without ``--quantize-kv`` (or ``--quant wide``) a wide bf16 KV cache,
which the engine serves through the split step. ``--tiered`` (with the
``--tier-*`` knobs) runs the tiered mixed-format cache:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --batch 8 --prompt-len 236 --shared-prefix 64 --ragged \
      --new-tokens 48 --tiered

``--step-mode megakernel`` runs each ragged step's whole layer stack as
one kernel launch (``kernels.mx_megakernel_step``), and logs the launches
a step takes; ``--step-mode split`` runs the reference's split step
(prefill-chunk dispatches under ``--prefill-token-budget``, then one
decode dispatch a step), and ``--decode-kernel einsum`` its gather
oracle, which also falls back to split. ``--temperature`` / ``--top-p`` /
``--top-k`` / ``--seed`` set the default sampling (each request's stream
from the base seed and its id), and ``--spec-decode`` drafts
``--num-draft-tokens`` tokens a step by prompt lookup and verifies them in
the same step:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --batch 8 --prompt-len 236 --shared-prefix 64 --ragged \
      --new-tokens 32 --temperature 0.8 --top-p 0.95 --seed 3 --spec-decode

``--serve`` starts the HTTP/SSE front end (``serve.server``) instead of
the batch workload: ``POST /v1/generate`` streams tokens as server-sent
events, ``/v1/cancel`` abandons a request, ``/v1/drain`` stops admitting
and waits for resident requests, ``GET /v1/health`` reports the overload
stats; ``--slo-ms`` / ``--max-queue`` arm load shedding (429), and
``--prefix-snapshot PATH`` loads a prefix-cache snapshot at start if the
file exists and writes it back after the drain on the way out:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --reduced --serve --port 8000 --slo-ms 500 --max-queue 16 \
      --prefix-snapshot prefix.npz --device cpu

``--prefill-mode monolithic`` admits each prompt with one dense prefill
(prefix hits may end mid-page) and decodes through the split step;
``--engine fixed`` runs the fixed-slot golden engine on a fixed batch
(the shared head and ``--prompt-len`` tokens a row) through its
``generate``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --reduced --batch 4 --prompt-len 24 --shared-prefix 16 \
      --new-tokens 8 --engine fixed --device cpu

``--prefill-max-chunks N`` lets a prefilling row take up to N chunks in
one ragged or megakernel step while fewer requests are active than slots
(a full batch takes one), so a long prompt beside a few short ones
reaches its first token in fewer steps; the report's
``prefill_rows_per_step`` is the prompt rows a prefill-carrying dispatch
retired:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --reduced --batch 2 --max-slots 4 --prompt-len 200 --ragged \
      --new-tokens 8 --prefill-max-chunks 4 --device cpu

Runs on the card unless ``--device cpu``. The reference's mesh flag is
not ported yet and exits with an error naming ROADMAP.md.
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os
import time

from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import MXFP4, MXFP8, WIDE
from repro_torch.nn import model
from repro_torch.serve import (AsyncServeEngine, FixedSlotEngine,
                               ServeConfig, ServeEngine, ServeHTTPServer,
                               TierPolicy)

log = logging.getLogger("repro_torch.serve")

#: flags of the reference launcher that this port does not take yet
UNPORTED_FLAGS = ("--mesh",)

TIER_FMTS = ["fp6_e3m2", "fp6_e2m3", "fp4_e2m1"]


def build_engine(args, params=None, **changes) -> tuple:
    """(model config, engine) of ``args`` (``--engine``: the continuous
    engine, or the fixed-slot one); ``params`` (of the same config) are
    reused, else random weights are made from seed 0. ``changes`` replace
    fields of the arch's config (``num_groups=8``: a depth cut that keeps
    every width; ``moe_dispatch="sorted"``)."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(**changes)
    quant = {"": cfg.quant, "wide": WIDE, "mxfp8": MXFP8,
             "mxfp4": MXFP4}[args.quant]
    cfg = cfg.replace(quant=quant.replace(
        block_size=cfg.quant.block_size, quantize_acts=False,
        quantize_kv_cache=args.quantize_kv or not args.quant))
    device = torch.device(args.device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init(cfg, gen, device)
    max_seq = args.shared_prefix + args.prompt_len + args.new_tokens
    if args.spec_decode:
        # room for the last verify window of a request
        max_seq += args.num_draft_tokens
    serve_cfg = ServeConfig(
        max_seq=max_seq, temperature=args.temperature, top_p=args.top_p,
        top_k=args.top_k, seed=args.seed,
        slo_ms=args.slo_ms or None,
        max_queue=args.max_queue if args.max_queue >= 0 else None,
        max_slots=args.max_slots or args.batch, page_size=args.page_size,
        prefix_cache=not args.no_prefix_cache,
        prefill_mode=args.prefill_mode, prefill_chunk=args.prefill_chunk,
        tiered=args.tiered,
        step_mode=args.step_mode, decode_kernel=args.decode_kernel,
        spec_decode=args.spec_decode,
        num_draft_tokens=args.num_draft_tokens,
        prefill_token_budget=args.prefill_token_budget or None,
        prefill_max_chunks=args.prefill_max_chunks,
        tier_policy=TierPolicy(
            mid_fmt=args.tier_mid_fmt, cold_fmt=args.tier_cold_fmt,
            hot_steps=args.tier_hot_steps, cold_steps=args.tier_cold_steps,
            repack_pages_per_step=args.tier_repack_pages)
        if args.tiered else None)
    kind = FixedSlotEngine if args.engine == "fixed" else ServeEngine
    return cfg, kind(params, cfg, serve_cfg, device=device)


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


def fixed_prompts(cfg, args) -> np.ndarray:
    """The fixed-slot workload, drawn as the reference launcher draws it:
    the ``--shared-prefix`` head, then ``--prompt-len`` tokens a row."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size,
                        size=(args.shared_prefix,)).astype(np.int32)
    tails = rng.integers(0, cfg.vocab_size,
                         size=(args.batch, args.prompt_len)).astype(np.int32)
    return np.concatenate(
        [np.broadcast_to(head, (args.batch, args.shared_prefix)), tails],
        axis=1)


def run_fixed(engine, cfg, args) -> dict:
    """The fixed-slot engine's batch through ``generate``, and a report."""
    prompts = fixed_prompts(cfg, args)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    generated = args.batch * args.new_tokens
    log.info("generated %s in %.2fs (%.1f tok/s, first row: %s...)",
             out.shape, dt, generated / dt, out[0, :12].tolist())
    return {"requests": args.batch, "seconds": dt,
            "generated_tokens": generated, "tokens_per_s": generated / dt,
            "prompts": prompts, "out": out}


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
    dispatches = {k[len("dispatches_"):]: v for k, v in stats.items()
                  if k.startswith("dispatches_")}
    report = {
        "requests": len(ids), "seconds": dt,
        "generated_tokens": generated, "tokens_per_s": generated / dt,
        "step_mode": stats["step_mode"],
        "steps": len(engine.step_seconds),
        "median_step_ms": 1e3 * float(np.median(engine.step_seconds)),
        "ragged_steps": stats["ragged_steps"],
        "dispatches": dispatches,
        "prefill_dispatches": stats["prefill_dispatches"],
        "prefill_rows_per_step": stats["prefill_rows_per_step"],
        "kernel_launches": stats["kernel_launches"],
        "launches_per_step": stats["launches_per_step"],
        "preemptions": stats["preemptions"],
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "peak_pages": stats["peak_pages"],
        "min_top2_gap_ulps": stats["min_top2_gap_ulps"],
        "min_sample_lead": stats["min_sample_lead"],
        "min_accept_margin": stats["min_accept_margin"],
        "prompts": prompts, "ids": ids, "results": results,
    }
    log.info("served %d requests in %.2fs (%.1f tok/s); %s step, %d steps "
             "(median %.1f ms); dispatches %s; %d kernel launches, %d "
             "preemptions, prefix hit rate %.2f", len(ids), dt,
             report["tokens_per_s"], report["step_mode"], report["steps"],
             report["median_step_ms"],
             ", ".join(f"{k} {v}" for k, v in dispatches.items()),
             report["kernel_launches"], report["preemptions"],
             report["prefix_hit_rate"])
    if stats["launches_per_step"] is not None:
        log.info("step audit: %d kernel launch(es) per engine step (%s "
                 "step; %.1f prefill tokens retired per prefill-carrying "
                 "dispatch)", stats["launches_per_step"],
                 report["step_mode"], stats["prefill_rows_per_step"])
    if engine.spec_enabled:
        report["spec"] = {k: stats[k] for k in (
            "spec_steps", "drafted_tokens", "accepted_tokens",
            "emitted_tokens", "accepted_per_step", "draft_acceptance_rate")}
        log.info("speculative decoding: %d verify steps, %.2f tokens "
                 "emitted per verify row, %d of %d drafts accepted",
                 stats["spec_steps"], stats["accepted_per_step"],
                 stats["accepted_tokens"], stats["drafted_tokens"])
    if engine.tiered:
        tiered = {k: v for k, v in stats.items() if k.startswith("pages_")
                  or k in ("unit_budget", "units_in_use", "peak_units",
                           "repacked_pages", "repack_dispatches",
                           "max_repacked_in_step")}
        report["tiered"] = tiered
        log.info("tiered KV: %d/%d quarter-page units in use (peak %d); "
                 "live pages by format: %s; %d pages repacked over %d "
                 "dispatches (max %d in one step)", tiered["units_in_use"],
                 tiered["unit_budget"], tiered["peak_units"],
                 ", ".join(f"{k[len('pages_'):]}: {v}"
                           for k, v in tiered.items()
                           if k.startswith("pages_")),
                 tiered["repacked_pages"], tiered["repack_dispatches"],
                 tiered["max_repacked_in_step"])
    return report


def _run_server(engine, args, until=None) -> None:
    """Serve HTTP/SSE over ``engine`` on ``args.host``:``args.port`` until
    interrupted, or until the coroutine ``until(server)`` returns; then
    drain, stop, and write the prefix snapshot back. ``--prefix-snapshot``
    is loaded first if its file exists."""
    async def serve():
        if args.prefix_snapshot and os.path.exists(args.prefix_snapshot):
            n = engine.load_prefix_cache(args.prefix_snapshot)
            log.info("warm-started prefix cache: %d entries from %s", n,
                     args.prefix_snapshot)
        aeng = AsyncServeEngine(engine)
        server = ServeHTTPServer(aeng, host=args.host, port=args.port)
        await server.start()
        log.info("serving on http://%s:%d (POST /v1/generate, /v1/cancel, "
                 "/v1/drain; GET /v1/health)", args.host, server.port)
        try:
            if until is None:
                await server.serve_forever()
            else:
                await until(server)
        finally:  # also on an interrupt, which cancels this task
            log.info("draining...")
            await aeng.drain()
            await server.stop()
            if args.prefix_snapshot:
                n = engine.save_prefix_cache(args.prefix_snapshot)
                log.info("saved prefix cache: %d pages to %s", n,
                         args.prefix_snapshot)

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests, and decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="default sampling temperature (0 = exact greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="default nucleus-sampling mass (1.0 = disabled)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="default top-k cutoff (0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="engine base RNG seed; each request's stream is "
                         "derived from (seed, request id)")
    ap.add_argument("--slo-ms", type=float, default=0,
                    help="admission-latency SLO in ms: shed submissions "
                         "(429) once the predicted first-token latency "
                         "exceeds it (0 = no latency-model shedding)")
    ap.add_argument("--max-queue", type=int, default=-1,
                    help="hard queue-depth cap; submissions past it are "
                         "shed (429). -1 = unbounded")
    ap.add_argument("--serve", action="store_true",
                    help="start the HTTP/SSE server instead of running "
                         "the batch workload")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--prefix-snapshot", default="",
                    help="path of a prefix-cache snapshot "
                         "(save_prefix_cache): loaded at start if it "
                         "exists, written back when the server exits")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="decode slots (default: --batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix-tree prompt sharing")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="chunked-prefill chunk length in tokens (a "
                         "multiple of --page-size)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: draft K tokens a step by "
                         "prompt lookup and verify them in the same step "
                         "(greedy prefix match at temperature 0, rejection "
                         "sampling above)")
    ap.add_argument("--num-draft-tokens", type=int, default=4,
                    help="drafts per sequence per verify step (K)")
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of common prompt head across requests "
                         "(exercises the prefix cache)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "fixed"],
                    help="'continuous' (default): continuous batching over "
                         "the paged MX cache; 'fixed': the fixed-slot "
                         "golden engine on a fixed batch")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "monolithic"],
                    help="prompt prefill path: 'chunked' (default) streams "
                         "fixed-size chunks straight into MX pages inside "
                         "the engine steps; 'monolithic' prefills each "
                         "prompt densely at admission, installs its cache "
                         "into pages, and decodes through the split step")
    ap.add_argument("--quant", default="",
                    choices=["", "wide", "mxfp8", "mxfp4"],
                    help="weight and KV format (default: the config's, "
                         "MXFP8, with an MX KV cache)")
    ap.add_argument("--quantize-kv", action="store_true",
                    help="MX KV cache; implied without --quant, and with "
                         "--quant off means a wide bf16 cache (served "
                         "through the split step)")
    ap.add_argument("--tiered", action="store_true",
                    help="tiered mixed-format KV cache: new pages land "
                         "fp8, idle pages are repacked down the fp8 -> "
                         "fp6 -> fp4 ladder under a per-step budget, and "
                         "the pool is metered in quarter-page units")
    ap.add_argument("--tier-mid-fmt", default="fp6_e3m2", choices=TIER_FMTS)
    ap.add_argument("--tier-cold-fmt", default="fp4_e2m1",
                    choices=TIER_FMTS)
    ap.add_argument("--tier-hot-steps", type=int, default=8)
    ap.add_argument("--tier-cold-steps", type=int, default=32)
    ap.add_argument("--tier-repack-pages", type=int, default=4)
    ap.add_argument("--decode-kernel", default="fused",
                    choices=["fused", "einsum"],
                    help="paged decode attention path: single-pass fused "
                         "flash-decode (default) or the reference "
                         "gather-and-dequantize einsum")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="max prefill tokens per engine step, spent "
                         "round-robin across admitted prompts "
                         "(default: one chunk)")
    ap.add_argument("--prefill-max-chunks", type=int, default=1,
                    help="ragged-aware prefill budgeting: chunks one "
                         "prefilling sequence may stream in a single "
                         "ragged step while the batch is undersubscribed "
                         "(fewer active sequences than slots); a full "
                         "batch always drops back to 1 chunk/step so "
                         "decode rows are never starved")
    ap.add_argument("--step-mode", default="ragged",
                    choices=["ragged", "split", "megakernel"],
                    help="engine step dispatch shape: 'ragged' (default) "
                         "packs decode tokens and prefill chunks into ONE "
                         "fused dispatch per step with the K/V write done "
                         "in-kernel; 'megakernel' runs that dispatch's "
                         "whole layer stack as ONE kernel launch; 'split' "
                         "runs the per-mode dispatches (the validated "
                         "oracle). Ragged needs the fused kernel + a "
                         "quantized KV cache and falls back to split "
                         "otherwise; megakernel falls back to ragged for "
                         "configs it cannot serve")
    args, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported to repro_torch yet (see "
                     "ROADMAP.md, section A)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.spec_decode and args.engine != "continuous":
        ap.error("--spec-decode requires --engine continuous (the "
                 "fixed-slot reference engine has no verify path)")
    if args.serve and args.engine != "continuous":
        ap.error("--serve requires --engine continuous (the async front "
                 "end drives the continuous-batching step loop)")
    if args.tiered and args.engine != "continuous":
        ap.error("--tiered requires --engine continuous")
    if args.tiered and (args.quant not in ("", "mxfp8")
                        or args.quant and not args.quantize_kv):
        ap.error("--tiered requires --quant mxfp8 --quantize-kv "
                 "(new writes land in the 8-bit base format)")
    return args


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg, engine = build_engine(args)
    if args.engine == "fixed":
        return run_fixed(engine, cfg, args)
    engine.warmup()
    if args.serve:
        return _run_server(engine, args)
    return run_batch(engine, cfg, args)


if __name__ == "__main__":
    main()
