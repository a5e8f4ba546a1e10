"""Training launcher (port of ``repro.launch.train``, one process on one
device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --reduced --device cpu --steps 2 --seq-len 16 --global-batch 4 \\
      --ckpt-dir /tmp/ckpt

Weights are f32 masters drawn from a ``torch.Generator`` seeded with
``WEIGHTS_SEED`` (0, as the reference's ``PRNGKey(0)``); the data is
``SyntheticLMDataset``'s counter-hash Markov stream, the reference's
batches exactly. Every linear trains through the
config's MX policy (MXFP8 QAT by default: both operands of every product
block-quantized each step, by #6 on the card). Fault tolerance as in the
reference: auto-resume from the newest complete checkpoint in
``--ckpt-dir`` (the reference's format, so either package resumes the
other's), SIGTERM/SIGINT save at the next step boundary, a straggler
watchdog, a checkpoint every ``--ckpt-every`` steps and at the end, all
under ``fault.run_with_restarts``.

Attention archs with a dense FFN train here: granite-8b, phi4-mini-3.8b,
llava-next-mistral-7b from token batches, as the reference's launcher;
gemma2-2b and gemma2-9b (GeGLU, post-norms, softcaps; gemma2-9b's f32
masters and AdamW state, ~148 GB, do not fit one 80 GB card at full
size: ``--reduced``) and musicgen-medium (its GELU FFN, from (B, S, 4)
codebook batches). The MoE, MLA and recurrent archs, ``--multihost``
and ``--model-parallel`` > 1 raise ``NotImplementedError`` (ROADMAP
A9b, A7). ``--device`` defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import logging
import statistics
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.nn import model
from repro_torch.train import (OptimConfig, checkpoint, fault, init_state,
                               make_train_step)

log = logging.getLogger("repro_torch.train")

#: the seed of the weights' generator
WEIGHTS_SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--quant", default="",
                    choices=["", "wide", "mxfp8", "mxfp4"])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def configure(args):
    """The model config and optimizer config the flags ask for; raises
    ``NotImplementedError`` for what is not ported."""
    if args.multihost:
        raise NotImplementedError(
            "--multihost (jax.distributed's multi-process data sharding) "
            "is not ported (ROADMAP A9b)")
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the FSDP/TP rules (state_axes, "
            "param_shardings), not ported (ROADMAP A9b, A7)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.quant:
        from repro_torch.core import MXFP4, MXFP8, WIDE

        cfg = cfg.replace(quant={"wide": WIDE, "mxfp8": MXFP8,
                                 "mxfp4": MXFP4}[args.quant].replace(
            block_size=cfg.quant.block_size))
    model.check_trainable(cfg)
    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    return cfg, opt_cfg


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible (pass "
                           "--device cpu for the CPU)")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(cfg, opt_cfg, dev, num_microbatches: int) -> tuple:
    """A fresh train state (seeded masters, zero moments) and the step."""
    gen = torch.Generator(dev).manual_seed(WEIGHTS_SEED)
    state = init_state(cfg, gen, dev)
    return state, make_train_step(cfg, opt_cfg, num_microbatches)


def run(args) -> dict:
    """Train as the flags say. Returns a report: the final step and, for
    the steps this process ran, loss, grad norm and lr by step, each
    step's milliseconds (host clock to a device sync), tokens a step and,
    on the card, the peak memory."""
    cfg, opt_cfg = configure(args)
    dev = _device(args.device)
    ds = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, num_codebooks=cfg.num_codebooks))
    guard = fault.PreemptionGuard()
    watchdog = fault.StragglerWatchdog()
    report = {"steps": [], "loss": [], "grad_norm": [], "lr": [],
              "step_ms": [], "tokens_per_step": args.seq_len
              * args.global_batch}

    def loop(_resume):
        state, step_fn = build(cfg, opt_cfg, dev, args.microbatches)
        start = 0
        if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) \
                is not None:
            state, start, _ = checkpoint.restore(args.ckpt_dir, state, cfg)
            log.info("resumed from step %d", start)
        for s in range(start, args.steps):
            watchdog.step_start()
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch_at(s).items()}
            state, metrics = step_fn(state, batch)
            _sync(dev)
            report["step_ms"].append(1e3 * (time.perf_counter() - t0))
            watchdog.step_end()
            vals = {k: float(metrics[k]) for k in ("loss", "grad_norm",
                                                   "lr")}
            report["steps"].append(s)
            for k, v in vals.items():
                report[k].append(v)
            if s % 10 == 0 or s == args.steps - 1:
                log.info("step %d loss %.4f gnorm %.3f lr %.2e", s,
                         vals["loss"], vals["grad_norm"], vals["lr"])
            should_save = args.ckpt_dir and (
                (s + 1) % args.ckpt_every == 0 or s == args.steps - 1
                or guard.should_stop)
            if should_save:
                checkpoint.save(args.ckpt_dir, s + 1, state, cfg,
                                extra={"data_step": s + 1})
            if guard.should_stop:
                log.warning("preempted: saved at step %d, exiting", s + 1)
                return s + 1
        return args.steps

    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        report["final_step"] = fault.run_with_restarts(loop, max_restarts=3)
    finally:
        guard.restore()
    report["stragglers"] = watchdog.flagged
    if dev.type == "cuda":
        report["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if report["step_ms"]:
        report["median_step_ms"] = statistics.median(report["step_ms"])
    log.info("training done at step %d (stragglers flagged: %d)",
             report["final_step"], watchdog.flagged)
    return report


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(args)


if __name__ == "__main__":
    main()
