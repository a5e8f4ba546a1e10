"""Mixture-of-Experts FFN with top-k routing and shared experts (port of
``repro.nn.moe``), unsharded.

The router runs in f32: logits ``x @ w_router``, a softmax over the
experts, the top ``k`` (ties to the lower expert index, as
``lax.top_k``), weights normalised to sum 1, and the Switch load-balancing
loss. Two dispatches compute the same function:

  * ``"dense"`` (the default, mixtral's): every expert runs on every token
    row, rows not routed to it zeroed, and the outputs are combined
    through the bf16 combine weights. It does ``num_experts / top_k``
    times the expert work of the routed rows;
  * ``"sorted"``: each token is replicated ``top_k`` times, the copies
    are sorted by expert id (a stable sort), and each projection runs one
    product per expert over that expert's contiguous group (the
    counterpart of ``lax.ragged_dot``); the rows are weighted in bf16 and
    added into their tokens in bf16, in the reference's scatter order.

Expert weights are ``(E, d_in, d_out)`` stacks, stored prepared: each
expert's slice fake-quantized along ``d_in`` (axis 1 of the stack, the
reference's ``_mx_expert_weight`` without a mesh) into bf16, once, by
``nn.linear.prepare_weight``, so weight-only MX alone is served here as
by every linear (MoE training waits for ROADMAP A9b). Activations
entering the experts stay wide, as in the reference; the shared experts
go through ``nn.ffn`` like any dense FFN. The
reference's products here are XLA dots, not Pallas kernels, so the port's
are ``torch.matmul``. Its mesh branches (the FSDP gather of MX expert
bytes, the data-parallel sorted dispatch, the expert-parallel layout
constraint) wait for sharded serving (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import QuantConfig
from repro_torch.core.dot import matmul

from . import common as C
from . import ffn, linear


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_shared: int = 0  # hidden width of the shared-expert branch (total)
    ffn_kind: str = "swiglu"
    router_norm_topk: bool = True  # normalise the top-k weights to sum 1
    aux_loss_weight: float = 0.01
    dispatch: str = "dense"  # "dense" | "sorted"


def _check(cfg: MoEConfig) -> None:
    if cfg.dispatch not in ("dense", "sorted"):
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r} "
                         "(expected 'dense' or 'sorted')")


def init(gen: torch.Generator, cfg: MoEConfig, quant: QuantConfig, device,
         compute_dtype=torch.bfloat16) -> dict:
    """Random weights from ``gen``. Each expert's projections are drawn in
    f32 and prepared one at a time into their slices of the bf16 stacks,
    so no f32 copy of a whole stack is ever held (mixtral-8x22b's is 3.2
    GB a projection)."""
    _check(cfg)
    e, dm, dff = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    shapes = {"gate": (dm, dff), "up": (dm, dff), "down": (dff, dm)}
    experts = {name: torch.empty((e, *shape), dtype=compute_dtype,
                                 device=device)
               for name, shape in shapes.items()}
    for i in range(e):
        for name, shape in shapes.items():
            experts[name][i] = linear.prepare_weight(
                C.truncated_normal_init(gen, shape, 1.0, device), quant,
                compute_dtype)
    params = {"router": {"w": C.truncated_normal_init(gen, (dm, e), 1.0,
                                                      device)},
              "experts": experts}
    if cfg.num_shared:
        params["shared"] = ffn.init(gen, dm, cfg.d_ff_shared, quant, device,
                                    cfg.ffn_kind)
    return params


def router(params, x: torch.Tensor, cfg: MoEConfig) -> tuple:
    """Top-k softmax routing in f32 of x (..., d_model). Returns (top_w
    (..., k) f32, top_idx (..., k) int64 in descending probability, lower
    index first on ties, probs (..., E) f32)."""
    logits = torch.matmul(x.to(torch.float32),
                          params["router"]["w"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps tied experts in index order, as
    # lax.top_k does (torch.topk leaves ties unspecified)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :cfg.top_k], top_idx[..., :cfg.top_k]
    if cfg.router_norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_idx, probs


def aux_loss(top_idx: torch.Tensor, probs: torch.Tensor,
             cfg: MoEConfig) -> torch.Tensor:
    """The Switch load-balancing loss ``E * <f_e, p_e>``: f_e the share of
    (token, slot) routes to expert e, p_e its mean probability."""
    one_hot = torch.nn.functional.one_hot(
        top_idx, cfg.num_experts).to(torch.float32)
    lead = tuple(range(probs.ndim - 1))
    frac_tokens = one_hot.sum(dim=-2).mean(dim=lead)
    frac_probs = probs.mean(dim=lead)
    return cfg.num_experts * (frac_tokens * frac_probs).sum()


def _activation(kind: str):
    return ffn.silu if kind == "swiglu" else ffn.gelu_tanh


def _gated(gate: torch.Tensor, up: torch.Tensor, kind: str,
           compute_dtype) -> torch.Tensor:
    """``act(gate).astype(dt) * up`` of a gate (bf16, or f32 sums) and a
    bf16 ``up``: the activation in f32 rounded to ``dt``, times ``up``,
    rounded once (the product of two bf16 values is exact in f32)."""
    act = C.round_to(_activation(kind)(gate.to(torch.float32)),
                     compute_dtype)
    return C.round_to(act.to(torch.float32) * up.to(torch.float32),
                      compute_dtype)


def _expert_ffn(w: dict, h_in: torch.Tensor, kind: str,
                compute_dtype) -> torch.Tensor:
    """Every expert's gated FFN on its rows h_in (E, N, d_model) bf16, at
    the jitted reference's rounding points: XLA merges the cast of the
    bf16 gate product to f32 into the product, so the activation reads
    the unrounded f32 sums; ``up`` and ``down`` are bf16 products
    accumulated in f32 and rounded once."""
    gate = matmul(h_in, w["gate"], torch.float32)
    up = torch.matmul(h_in, w["up"])
    return torch.matmul(_gated(gate, up, kind, compute_dtype), w["down"])


def _dense(w: dict, x: torch.Tensor, top_w: torch.Tensor,
           top_idx: torch.Tensor, cfg: MoEConfig,
           compute_dtype) -> torch.Tensor:
    """The dense dispatch (see the module docstring) of x (B, T,
    d_model) through the expert stacks ``w``."""
    b, t, d = x.shape
    combine = torch.zeros((b, t, cfg.num_experts), dtype=torch.float32,
                          device=x.device).scatter_(-1, top_idx, top_w)
    dispatch = (combine > 0).to(compute_dtype)
    h_in = dispatch.permute(2, 0, 1)[..., None] * x.to(compute_dtype)[None]
    h_out = _expert_ffn(w, h_in.reshape(cfg.num_experts, b * t, d),
                        cfg.ffn_kind, compute_dtype)
    # each token's experts' outputs times their bf16 weights: exact f32
    # products summed over the experts in f32, rounded once
    weights = combine.to(compute_dtype).to(torch.float32)
    out = (h_out.reshape(cfg.num_experts, b, t, d).to(torch.float32)
           * weights.permute(2, 0, 1)[..., None]).sum(dim=0)
    return out.to(compute_dtype)


def _sorted(w: dict, x: torch.Tensor, top_w: torch.Tensor,
            top_idx: torch.Tensor, cfg: MoEConfig,
            compute_dtype) -> torch.Tensor:
    """The sorted dispatch (see the module docstring) of x (B, T,
    d_model) through the expert stacks ``w``. The groups' sizes are read
    on the host, one sync a call."""
    b, t, d = x.shape
    k, n = cfg.top_k, b * t
    ids = top_idx.reshape(n * k)
    order = torch.argsort(ids, stable=True)
    xs = x.reshape(n, d)[order // k].to(compute_dtype)
    sizes = torch.bincount(ids, minlength=cfg.num_experts).tolist()
    rows = torch.cat([
        torch.matmul(_gated(torch.matmul(xg, w["gate"][i]),
                            torch.matmul(xg, w["up"][i]), cfg.ffn_kind,
                            compute_dtype), w["down"][i])
        for i, xg in enumerate(torch.split(xs, sizes))])
    wts = top_w.reshape(n * k).to(compute_dtype)[order]
    rows = C.round_to(rows.to(torch.float32) * wts.to(torch.float32)[:, None],
                      compute_dtype)
    # the reference scatter-adds the sorted rows into bf16 zeros in sorted
    # order: a token's rows arrive by ascending expert id, each add rounded
    # to bf16. Adding them in that order here needs no atomics.
    by_slot = torch.empty_like(rows)
    by_slot[order] = rows
    by_slot = by_slot.reshape(n, k, d)
    by_id = torch.gather(by_slot, 1, torch.argsort(top_idx.reshape(n, k),
                                                   dim=-1)[..., None]
                         .expand(n, k, d))
    out = by_id[:, 0]
    for j in range(1, k):
        out = C.round_to(out.to(torch.float32)
                         + by_id[:, j].to(torch.float32), compute_dtype)
    return out.reshape(b, t, d)


def apply(params, x: torch.Tensor, cfg: MoEConfig,
          compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """MoE FFN of x (B, T, d_model) by ``cfg.dispatch``, plus the shared
    experts: out (B, T, d_model) in ``compute_dtype``. The reference's
    ``apply`` also returns the auxiliary loss, which serving drops; here
    it is :func:`aux_loss` of :func:`router`'s indices and probabilities,
    computed only where it is wanted. A ``mesh`` raises (ROADMAP A7)."""
    if mesh is not None:
        raise NotImplementedError(
            "MoE under a device mesh (FSDP-gathered MX expert bytes, the "
            "data-parallel sorted dispatch) is not ported to repro_torch "
            "yet (ROADMAP A7)")
    _check(cfg)
    top_w, top_idx, _ = router(params, x, cfg)
    dispatch = _sorted if cfg.dispatch == "sorted" else _dense
    out = dispatch(params["experts"], x, top_w, top_idx, cfg, compute_dtype)
    if cfg.num_shared:
        out = out + ffn.apply(params["shared"], x, cfg.ffn_kind,
                              compute_dtype)
    return out
