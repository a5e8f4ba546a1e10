"""AdamW, learning-rate schedules and global-norm clipping (port of
``repro.train.optim``).

The optimizer state mirrors the parameter tree (``m`` and ``v`` in f32,
``step`` an int32 scalar on the host). Every operation is the
reference's, in its order, but :func:`apply` updates the parameters and
moments in place and in slices of at most ``CHUNK`` elements of a leaf:
the update is elementwise, so the slices give the same bits as whole
leaves, and no temporary the size of a whole leaf (the embedding's
614.6 M elements at phi4-mini) is made. The only reduction is
:func:`global_norm`; its order is stated there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import host_math
from repro_torch.nn.model import leaves

#: elements of a leaf updated at a time
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"


def _fma32(a, b, c) -> np.float32:
    """f32 ``a * b + c`` rounded once (an exact f64 product and sum)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def lr_at(cfg: OptimConfig, step: int) -> float:
    """The learning rate at ``step`` in the reference's f32 arithmetic as
    its jitted step computes it (on the host): XLA rewrites the divides by
    the constant warmup and decay lengths into multiplies by their f32
    reciprocals (C5) and contracts the decay's multiply-add into one FMA;
    the cos is the C library's ``cosf``, which XLA:CPU's f32 cos equals
    (C3)."""
    f = np.float32
    s = f(step)
    warm = min(s * (f(1.0) / f(max(cfg.warmup_steps, 1))), f(1.0))
    span = f(1.0) / f(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = min(max((s - f(cfg.warmup_steps)) * span, f(0.0)), f(1.0))
    lo = f(cfg.min_lr_ratio)
    if cfg.schedule == "cosine":
        cos, _ = host_math.cos_sin(torch.tensor([f(np.pi) * t]))
        decay = _fma32(f(1.0) + f(cos.item()),
                       f((1 - cfg.min_lr_ratio) * 0.5), lo)
    elif cfg.schedule == "linear":
        decay = _fma32(f(1.0) - t, f(1 - cfg.min_lr_ratio), lo)
    else:
        decay = f(1.0)
    return float(f(cfg.lr) * warm * decay)


def tree_like(fn, tree):
    """``tree``'s structure with ``fn(leaf)`` at each leaf, called in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        out = {k: tree_like(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, list):
        return [tree_like(fn, v) for v in tree]
    return fn(tree)


def init(params) -> dict:
    """Zero f32 moments shaped like ``params``, and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_like(zeros, params), "v": tree_like(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(norm_leaves: list) -> torch.Tensor:
    """``sqrt`` of the sum of squares of every gradient, f32. Order: each
    entry of ``norm_leaves`` (a tensor, or a list of tensors that are one
    reference leaf's layers) gives one sum: a ``torch.sum`` of the squares
    of each tensor (of each slice of at most CHUNK elements), added in
    order; the entries' sums are added in the list's order from zero, as
    the reference's ``sum`` over its leaves."""
    total = None
    for entry in norm_leaves:
        parts = entry if isinstance(entry, list) else [entry]
        leaf = None
        for x in parts:
            flat = x.reshape(-1).to(torch.float32)
            for a in range(0, flat.numel(), CHUNK):
                s = torch.sum(torch.square(flat[a:a + CHUNK]))
                leaf = s if leaf is None else leaf + s
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in f32 (a python ``b`` rounded to f32 first, as the
    reference's weakly typed constants are). On CPU tensors one rounding,
    as XLA:CPU
    contracts the reference's multiply-adds into FMAs (exact f64 product
    and sum, rounded once to f32); on the card the two f32 operations."""
    if a.device.type == "cpu":
        b = b.double() if isinstance(b, torch.Tensor) else float(
            np.float32(b))
        return (a.double() * b + c.double()).to(torch.float32)
    return a * b + c


@torch.no_grad()
def _update(p, g, m, v, scale, lr: float, bc1: float, bc2: float,
            cfg: OptimConfig) -> None:
    """The reference's ``upd`` of one leaf, in place, slice by slice, as
    its jitted step computes it: ``m = fma(m, b1, (1 - b1) g)``, ``v =
    fma(v, b2, (1 - b2) g g)``, the bias corrections folded into one
    divide, ``m / (bc1 (sqrt(v / bc2) + eps))`` (XLA's algebraic
    rewrite of ``(m / bc1) / (sqrt(v / bc2) + eps)``), then ``delta =
    fma(p, wd, that)`` and ``p = fma(-lr, delta, p)``."""
    b1, b2 = cfg.betas
    pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
    for a in range(0, pf.numel(), CHUNK):
        sl = slice(a, a + CHUNK)
        gs = gf[sl].to(torch.float32)
        if scale is not None:
            gs = gs * scale
        mf[sl] = _fma(mf[sl], b1, gs * (1 - b1))
        vf[sl] = _fma(vf[sl], b2, gs * (1 - b2) * gs)
        p32 = pf[sl].to(torch.float32)
        q = mf[sl] / (bc1 * (torch.sqrt(vf[sl] / bc2) + cfg.eps))
        delta = _fma(p32, cfg.weight_decay, q)
        pf[sl] = _fma(delta, -lr, p32).to(p.dtype)


def apply(cfg: OptimConfig, params, grads, state: dict,
          norm_leaves: Optional[list] = None) -> tuple:
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    updated and returned, with ``{"grad_norm", "lr"}``. ``grads`` has the
    params' structure; ``norm_leaves`` (default: its leaves in
    :func:`leaves` order) orders the global norm's sum."""
    step = int(state["step"]) + 1
    gnorm = global_norm(leaves(grads) if norm_leaves is None
                        else norm_leaves)
    scale = None
    if cfg.clip_norm is not None:
        clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                            device=gnorm.device)
        scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))
    lr = lr_at(cfg, step)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        _update(p, g, m, v, scale, lr, bc1, bc2, cfg)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, {"grad_norm": gnorm, "lr": torch.tensor(
        lr, dtype=torch.float32)}
