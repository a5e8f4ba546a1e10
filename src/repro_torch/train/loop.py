"""Training step builder (port of ``repro.train.loop``, one process):
gradient accumulation over microbatches, MX gradient compression, AdamW.

``make_train_step(cfg, opt_cfg, num_microbatches)`` returns ``(state,
batch) -> (state, metrics)``, which updates ``state`` in place. Gradients
accumulate in f32 over the microbatches in order, are scaled by
``1 / num_microbatches`` (the loss too), optionally fake-quantized to
MXFP8-E5M2 blocks of 32 (``quant.quantize_grads``), then fed to
``optim.apply``. The reference's ``state_axes`` and ``param_shardings``
belong to its FSDP/TP rules (ROADMAP A7).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize_value
from repro_torch.nn import model
from repro_torch.nn.config import ModelConfig

from . import optim


#: Observers of a train step's parts, each called as ``mark(part)`` where
#: a part begins ("forward" and "backward" for each microbatch, then
#: "compress" when the gradients are compressed, and "optimizer") and as
#: ``mark("end")`` after the update. Empty unless a caller times the parts
#: (``chip_smoke.py`` records a CUDA event at each mark).
PART_MARKS: list = []


def _mark(part: str) -> None:
    for mark in PART_MARKS:
        mark(part)


def _compress_grads(grads, cfg: ModelConfig) -> None:
    """Fake-quantize the gradients to MXFP8-E5M2 blocks of 32 along their
    last axis, in place (:func:`compress_leaves` over the reference's
    leaves)."""
    compress_leaves(model.reference_leaves(cfg, grads))


def compress_leaves(entries: list) -> None:
    """The reference's ``_compress_grads`` over its leaves, in place: each
    entry a tensor or a list of the tensors that are one stacked leaf's
    layers. A leaf whose size is not a multiple of 32 (or a scalar) stays
    wide; the others are quantized along their last axis, so a last axis
    that is not a multiple of 32 raises ``ValueError``, as in the
    reference."""
    for entry in entries:
        parts = entry if isinstance(entry, list) else [entry]
        if not isinstance(entry, list) and entry.ndim == 0:
            continue
        if sum(g.numel() for g in parts) % 32:
            continue
        with torch.no_grad():
            for g in parts:
                g.copy_(quantize_value(g.to(torch.float32), "fp8_e5m2", 32))


def trainable(params) -> list:
    """The parameter leaves, each set to require a gradient."""
    return [p.requires_grad_(True) for p in optim.leaves(params)]


def _split(batch: dict, n: int) -> list:
    def part(x, i):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]

    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


def loss_and_grads(params, cfg: ModelConfig, batch: dict,
                   num_microbatches: int = 1) -> tuple:
    """(loss, the last microbatch's metrics, f32 gradients in the params'
    structure) of ``batch``, its rows split into ``num_microbatches``
    equal microbatches: the gradients summed over them in order in f32,
    then both scaled by ``1 / num_microbatches``."""
    leaves = trainable(params)
    acc, loss_sum = None, None
    for mb in (_split(batch, num_microbatches) if num_microbatches > 1
               else [batch]):
        _mark("forward")
        loss, metrics = model.loss_fn(params, cfg, mb)
        _mark("backward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.to(torch.float32)
                 for p, g in zip(leaves, grads)]
        if acc is None:
            acc, loss_sum = grads, loss.detach()
        else:
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss.detach()
        del grads, loss
    if num_microbatches > 1:
        inv = 1.0 / num_microbatches
        for a in acc:
            a.mul_(inv)
        loss_sum = loss_sum * inv
    it = iter(acc)
    tree = optim.tree_like(lambda _: next(it), params)
    return loss_sum, {k: v.detach() for k, v in metrics.items()}, tree


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptimConfig,
                    num_microbatches: int = 1):
    """The train step (see the module docstring)."""
    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                              num_microbatches)
        if cfg.quant.enabled and cfg.quant.quantize_grads:
            _mark("compress")
            _compress_grads(grads, cfg)
        _mark("optimizer")
        _, opt, opt_metrics = optim.apply(
            opt_cfg, params, grads, state["opt"],
            norm_leaves=model.reference_leaves(cfg, grads))
        _mark("end")
        del grads
        return ({"params": params, "opt": opt},
                {**metrics, **opt_metrics, "loss": loss})

    return train_step


def init_state(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Seeded f32 masters (``model.init_train``) and a fresh AdamW state."""
    params = model.init_train(cfg, gen, device)
    trainable(params)
    return {"params": params, "opt": optim.init(params)}
