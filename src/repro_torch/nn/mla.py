"""Multi-head latent attention (port of ``repro.nn.mla``; DeepSeek-V2).

V2-Lite's form: keys and values are compressed jointly into a
``kv_lora``-wide latent plus one ``qk_rope_dim``-wide RoPE key shared by
every head; queries are full-rank. The decode cache holds only the latent
and the rotated shared key, ``kv_lora + qk_rope_dim`` values a token, in
bf16 whatever the quantization policy (the reference's ``init_cache``
ignores it), as the dict ``{"c_kv", "k_rope", "kpos"}``.

Prefill (:func:`apply_train`'s forward) re-expands the
latent through ``wk_b`` / ``wv_b`` like every projection, fake-quantized.
The decode (:func:`apply_decode`) runs in the *absorbed* form: the query
is projected into latent space through ``wk_b`` and attends over the
latent cache directly, and the values are un-absorbed through ``wv_b``
afterwards. The reference's decode reads those two weights as its f32
masters cast to bf16, with no fake quantization, so the port keeps both
forms of each (:func:`absorbed_weight`): ``"w"``, the prepared weight
that prefill multiplies, and ``"raw"``, the cast that the decode
multiplies.

Every product has the reference's rounding points: f32 sums of bf16
operands, rounded once where the reference's output is bf16. The decode's
one-row products may sum in another order than XLA:CPU's dot (see
``tests/test_torch_mla.py`` for the bar). Training MLA is not ported
(ROADMAP A9b).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import QuantConfig

from . import common as C
from . import linear
from .attention import NEG_INF, _mask, _Softmax, rope_len
from .norms import rmsnorm_apply, rmsnorm_init
from .rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    query_chunk: int = 1024


def absorbed_weight(w: torch.Tensor, quant: QuantConfig,
                    compute_dtype=torch.bfloat16) -> dict:
    """Both forms of ``wk_b`` or ``wv_b`` from its f32 master ``w``:
    ``"w"`` fake-quantized as every projection (prefill's), ``"raw"`` the
    plain cast to ``compute_dtype`` (the absorbed decode's)."""
    return {"w": linear.prepare_weight(w, quant, compute_dtype),
            "raw": w.to(torch.float32).to(compute_dtype)}


def init(gen: torch.Generator, cfg: MLAConfig, quant: QuantConfig, device,
         compute_dtype=torch.bfloat16) -> dict:
    """Random weights from ``gen``, in the reference's shapes."""
    h, dm, lora = cfg.num_heads, cfg.d_model, cfg.kv_lora
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim

    def absorbed(d_out):
        return absorbed_weight(C.truncated_normal_init(
            gen, (lora, d_out), 1.0, device), quant, compute_dtype)

    return {"wq": linear.init(gen, dm, h * qd, quant, device),
            "wkv_a": linear.init(gen, dm, lora + cfg.qk_rope_dim, quant,
                                 device),
            "wk_b": absorbed(h * cfg.qk_nope_dim),
            "wv_b": absorbed(h * cfg.v_head_dim),
            "wo": linear.init(gen, h * cfg.v_head_dim, dm, quant, device),
            "kv_norm": rmsnorm_init(lora, device)}


def _project_q(params, x: torch.Tensor, cfg: MLAConfig, dt) -> tuple:
    b, s, _ = x.shape
    q = linear.apply(params["wq"], x, dt).reshape(
        b, s, cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _latent(params, x: torch.Tensor, cfg: MLAConfig, dt) -> tuple:
    """(the normed latent, the unrotated shared RoPE key). The latent's
    RMSNorm takes ``rmsnorm_apply``'s default eps, as the reference's."""
    kv = linear.apply(params["wkv_a"], x, dt)
    c_kv = rmsnorm_apply(params["kv_norm"], kv[..., :cfg.kv_lora])
    return c_kv, kv[..., cfg.kv_lora:]


def _scale(cfg: MLAConfig) -> float:
    """The reference's ``d_total ** -0.5``: a Python float that JAX takes
    as an f32 constant, so the f32 rounding of the double."""
    return float(np.float32((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5))


def _masked_probs(logits: torch.Tensor, qpos: torch.Tensor,
                  kpos: torch.Tensor, dt) -> torch.Tensor:
    """Causal softmax of f32 ``logits`` (B, H, S, T), key position -1
    masked with ``NEG_INF`` (``attention._mask``), rounded to ``dt``."""
    mask = _mask(qpos, kpos, None)[:, None]  # (B, 1, S, T)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return _Softmax.apply(logits).to(dt)


def _attend_mla(q_nope, q_rope, k_nope, k_rope, v, qpos, kpos,
                cfg: MLAConfig, dt) -> torch.Tensor:
    """Attention with decoupled nope / rope logits, ``k_rope`` (B, T,
    rope) shared by every head. Returns (B, S, H, v_head_dim)."""
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * _scale(cfg)
    probs = _masked_probs(logits, qpos, kpos, dt)
    return torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(dt)


def apply_train(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: MLAConfig, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference's ``apply_train`` forward over prepared weights
    (serving's prefill compute): x (B, S, d_model) at ``positions`` (B, S)
    -> (B, S, d_model)."""
    dt = compute_dtype
    b, s, _ = x.shape
    h = cfg.num_heads
    n = rope_len(int(positions.max()) + 1)
    q_nope, q_rope = _project_q(params, x, cfg, dt)
    c_kv, k_rope = _latent(params, x, cfg, dt)
    k_nope = linear.apply(params["wk_b"], c_kv, dt).reshape(
        b, s, h, cfg.qk_nope_dim)
    v = linear.apply(params["wv_b"], c_kv, dt).reshape(
        b, s, h, cfg.v_head_dim)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, n)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta,
                        n)[..., 0, :]
    cs = cfg.query_chunk
    if s > cs and s % cs == 0:
        # the reference maps over query chunks of cs rows, each against
        # every key; a row's result does not depend on its chunk
        out = torch.cat([_attend_mla(
            q_nope[:, i:i + cs], q_rope[:, i:i + cs], k_nope, k_rope, v,
            positions[:, i:i + cs], positions, cfg, dt)
            for i in range(0, s, cs)], dim=1)
    else:
        out = _attend_mla(q_nope, q_rope, k_nope, k_rope, v, positions,
                          positions, cfg, dt)
    return linear.apply(params["wo"], out.reshape(b, s, -1), dt)


# -- latent cache -----------------------------------------------------------


def init_cache(batch: int, max_seq: int, cfg: MLAConfig, device) -> dict:
    """An empty latent cache (bf16 whatever the quantization policy)."""
    def zeros(width):
        return torch.zeros((batch, max_seq, width), dtype=torch.bfloat16,
                           device=device)

    return {"c_kv": zeros(cfg.kv_lora), "k_rope": zeros(cfg.qk_rope_dim),
            "kpos": torch.full((max_seq,), -1, dtype=torch.int32,
                               device=device)}


def prefill_cache(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: MLAConfig, max_seq: int,
                  compute_dtype=torch.bfloat16) -> dict:
    """The latent cache of x (B, S, d_model) at ``positions`` (B, S), in
    slots 0..S-1 of ``max_seq``."""
    c_kv, k_rope = _latent(params, x, cfg, compute_dtype)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta,
                        rope_len(int(positions.max()) + 1))[..., 0, :]
    b, s = positions.shape
    cache = init_cache(b, max_seq, cfg, x.device)
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    cache["kpos"][:s] = positions[0]
    return cache


def apply_decode(params, x: torch.Tensor, cache: dict, pos: int,
                 cfg: MLAConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One-token decode in the absorbed form: x (B, 1, d_model) at the
    shared position ``pos``. Writes the token's latent and rotated key at
    slot ``pos`` (clamped to the last slot, as the reference's
    ``dynamic_update_slice``; ``cache`` in place), then attends over the
    whole cache through ``wk_b`` / ``wv_b``'s ``"raw"`` casts."""
    dt = compute_dtype
    b, h, lora = x.shape[0], cfg.num_heads, cfg.kv_lora
    q_nope, q_rope = _project_q(params, x, cfg, dt)
    c_new, kr_new = _latent(params, x, cfg, dt)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    n = rope_len(pos + 1)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta, n)
    kr_new = apply_rope(kr_new[..., None, :], posv, cfg.rope_theta,
                        n)[..., 0, :]
    slot = min(pos, cache["kpos"].shape[0] - 1)
    cache["c_kv"][:, slot] = c_new[:, 0]
    cache["k_rope"][:, slot] = kr_new[:, 0]
    cache["kpos"][slot] = pos
    c_kv = cache["c_kv"].float()
    wk_b = params["wk_b"]["raw"].reshape(lora, h, cfg.qk_nope_dim).float()
    wv_b = params["wv_b"]["raw"].reshape(lora, h, cfg.v_head_dim).float()
    q_eff = torch.einsum("bshd,lhd->bshl", q_nope.float(), wk_b).to(dt)
    logits = (torch.einsum("bshl,btl->bhst", q_eff.float(), c_kv)
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             cache["k_rope"].float())) * _scale(cfg)
    probs = _masked_probs(logits, posv, cache["kpos"][None], dt)
    out_lat = torch.einsum("bhst,btl->bshl", probs.float(), c_kv).to(dt)
    out = torch.einsum("bshl,lhd->bshd", out_lat.float(), wv_b).to(dt)
    return linear.apply(params["wo"], out.reshape(b, 1, -1), dt)
