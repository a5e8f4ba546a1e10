"""Mamba2 SSD (state-space duality) block, chunked-scan form (port of
``repro.nn.ssd``).

Prefill runs the quadratic-within-chunk / linear-across-chunk SSD
algorithm (Mamba2, Listing 1): attention-like products inside each chunk
of ``chunk`` tokens plus a recurrence of chunk-end states through
segment-sum decays. A prompt must be at most one chunk long or a multiple
of it, as in the reference (its assertion, ported as it is). Decode is
the O(1) update of the (B, H, P, N) state. The state is ``{"h": (B, H,
P, N) f32, "conv": (B, conv_width - 1, conv_dim) f32}``.

The in/out projections run through ``linear.apply``; the convolution and
the scan stay in f32. The reference's four-operand einsums are written as
the pairwise products its jaxpr holds (opt_einsum's path), each in the
same operand order. On CPU tensors every f32 product sums as XLA:CPU's
dot does at that shape (``host_math.dot`` / ``dot_lanes``), and exp,
softplus and the contracted multiply-adds are XLA:CPU's; on the card the
products are torch's (TF32 off).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import host_math
from repro_torch.core.formats import flush_subnormals

from . import common as C
from . import linear
from .norms import rmsnorm_apply, rmsnorm_init
from .rglru import _conv_step, _cpu, _exp, _fma, _softplus, causal_conv

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_inner: int  # expand * d_model
    headdim: int = 64  # P
    d_state: int = 128  # N
    ngroups: int = 1  # G
    conv_width: int = 4
    chunk: int = 256

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state


def init(gen: torch.Generator, cfg: SSDConfig, quant, device) -> dict:
    """Random weights from ``gen`` in the reference's shapes; ``A_log`` is
    ``log(linspace(1, 16, H))``, ``dt_bias`` zeros and ``D`` ones, as
    there."""
    h = cfg.nheads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + h
    return {
        "in_proj": linear.init(gen, cfg.d_model, d_in_proj, quant, device),
        "out_proj": linear.init(gen, cfg.d_inner, cfg.d_model, quant,
                                device),
        "norm": rmsnorm_init(cfg.d_inner, device),
        "conv_w": C.truncated_normal_init(gen, (cfg.conv_width,
                                                cfg.conv_dim), 1.0, device),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=torch.float32,
                              device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
    }


#: f32 batched products in XLA:CPU's order for the shape on CPU tensors
_bmm = host_math.matmul


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` over the last axis: left to right in f32."""
    out = x.clone()
    for i in range(1, x.shape[-1]):
        out[..., i] = out[..., i - 1] + x[..., i]
    return out


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular segment sums,
    S[i, j] = sum_{j < k <= i} x[k], NEG_INF above the diagonal."""
    t = x.shape[-1]
    cs = _cumsum(x)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(t, device=x.device)
    return torch.where(i[:, None] >= i[None, :], d,
                       torch.full_like(d, NEG_INF))


def _ssd_scan(x, dt, A, B, Cm, cfg: SSDConfig, init_state=None) -> tuple:
    """Chunked SSD: x (b, l, h, p) f32, dt (b, l, h), A (h,), B and Cm (b,
    l, g, n). Returns (y (b, l, h, p), the final state (b, h, p, n))."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(cfg.chunk, l)
    if l % q:  # the reference's assertion, raised whatever python's -O
        raise AssertionError(f"seq {l} not divisible by chunk {q}")
    nc = l // q
    rep = h // g

    xd = x * dt[..., None]
    Ad = A[None, None, :] * dt
    xc = xd.reshape(b, nc, q, h, p)
    Ac = Ad.reshape(b, nc, q, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    Bh = B.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)

    A_cumsum = _cumsum(Ac)
    L = _exp(_segsum(Ac))  # (b, h, c, q, s)

    # 1) inside each chunk: (C . B) over n, times L, then over s with x
    cb = _bmm(Ch.permute(0, 1, 3, 2, 4), Bh.permute(0, 1, 3, 4, 2))
    m = cb * L.permute(0, 2, 1, 3, 4)  # (b, c, h, q, s)
    y_diag = _bmm(m, xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # 2) chunk-end states: (decay * x) . B over q
    decay_states = _exp(A_cumsum[..., -1:] - A_cumsum)  # (b, h, c, q)
    xs = decay_states.permute(0, 2, 3, 1)[..., None] * xc  # (b, c, q, h, p)
    states = _bmm(xs.permute(0, 1, 3, 4, 2),
                  Bh.permute(0, 1, 3, 2, 4))  # (b, c, h, p, n)

    # 3) across chunks: the states through the chunk sums' decays
    chunk_sum = A_cumsum[..., -1]
    padded = torch.nn.functional.pad(chunk_sum, (1, 0))
    decay_chunk = _exp(_segsum(padded))  # (b, h, z, c)
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                 device=x.device)
    states_all = torch.cat([init_state[:, None], states], dim=1)
    sa = states_all.permute(0, 2, 3, 4, 1).reshape(b, h, p * n, nc + 1)
    new = _bmm(sa, decay_chunk.transpose(-1, -2))  # (b, h, p*n, z)
    new_states = new.reshape(b, h, p, n, nc + 1).permute(0, 4, 1, 2, 3)
    prev_states = new_states[:, :-1]
    final_state = new_states[:, -1]

    # 4) the states entering each chunk, read by C, times their decay
    state_decay = _exp(A_cumsum)  # (b, h, c, q)
    cs = _bmm(prev_states, Ch.permute(0, 1, 3, 4, 2))  # (b, c, h, p, q)
    y_off = (state_decay.permute(0, 2, 1, 3)[:, :, :, None] * cs).permute(
        0, 1, 4, 2, 3)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, final_state.contiguous()


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in f32: x * sigmoid(x) with XLA:CPU's sigmoid on
    CPU tensors, subnormals flushed."""
    if _cpu(x):
        return flush_subnormals(x * flush_subnormals(host_math.logistic(x)))
    return flush_subnormals(x * flush_subnormals(torch.sigmoid(x)))


def _split_proj(zxbcdt: torch.Tensor, cfg: SSDConfig) -> tuple:
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def _post(params, y: torch.Tensor, z: torch.Tensor, cfg: SSDConfig,
          dt) -> torch.Tensor:
    """The gated RMSNorm over ``d_inner`` and the output projection."""
    gated = y.to(torch.float32) * _silu(z.to(torch.float32))
    normed = rmsnorm_apply(params["norm"], gated.to(dt))
    return linear.apply(params["out_proj"], normed, dt)


def _dt(params, dt_raw: torch.Tensor) -> torch.Tensor:
    return _softplus(dt_raw + params["dt_bias"])


def apply_train(params, xin: torch.Tensor, cfg: SSDConfig,
                compute_dtype=torch.bfloat16, init_state=None,
                return_state: bool = False):
    """The mixer over the full sequence xin (B, S, d_model); with
    ``return_state`` also the final SSD state (B, H, P, N), from
    ``init_state`` if given."""
    zxbcdt = linear.apply(params["in_proj"], xin, compute_dtype)
    out, state = _forward(params, zxbcdt.to(torch.float32), cfg,
                          compute_dtype, init_state)
    return (out, state) if return_state else out


def _forward(params, zxbcdt: torch.Tensor, cfg: SSDConfig, compute_dtype,
             init_state=None) -> tuple:
    """The mixer from its f32 input projection: (output, final state)."""
    b, s, _ = zxbcdt.shape
    h, p, g, n = cfg.nheads, cfg.headdim, cfg.ngroups, cfg.d_state
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc = _silu(causal_conv(xbc, params["conv_w"].to(torch.float32))
                + params["conv_b"].to(torch.float32))
    di = cfg.d_inner
    x = xbc[..., :di].reshape(b, s, h, p)
    B = xbc[..., di:di + g * n].reshape(b, s, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = _dt(params, dt_raw)
    A = -_exp(params["A_log"])
    y, state = _ssd_scan(x, dt, A, B, Cm, cfg, init_state)
    y = _fma(params["D"][None, None, :, None], x, y)
    return _post(params, y.reshape(b, s, -1), z, cfg, compute_dtype), state


def init_state(batch: int, cfg: SSDConfig, device) -> dict:
    return {"h": torch.zeros((batch, cfg.nheads, cfg.headdim, cfg.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                                dtype=torch.float32, device=device)}


def apply_decode(params, xin: torch.Tensor, state: dict, cfg: SSDConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One token xin (B, 1, d_model) against ``state``, updated in place
    (every row, as the reference's step). Returns (B, 1, d_model)."""
    b = xin.shape[0]
    h, p, g, n = cfg.nheads, cfg.headdim, cfg.ngroups, cfg.d_state
    zxbcdt = linear.apply(params["in_proj"], xin, compute_dtype)
    z, xbc_new, dt_raw = _split_proj(zxbcdt.to(torch.float32)[:, 0], cfg)
    w = params["conv_w"].to(torch.float32)
    hist = torch.cat([state["conv"], xbc_new[:, None]], dim=1)
    xbc = _silu(_conv_step(hist, w) + params["conv_b"].to(torch.float32))
    di = cfg.d_inner
    x = xbc[..., :di].reshape(b, h, p)
    rep = h // g
    Bh = xbc[..., di:di + g * n].reshape(b, g, n).repeat_interleave(rep, 1)
    Ch = xbc[..., di + g * n:].reshape(b, g, n).repeat_interleave(rep, 1)
    dt = _dt(params, dt_raw)
    A = -_exp(params["A_log"])
    decay = _exp(A[None] * dt)
    outer = (x * dt[..., None])[..., :, None] * Bh[:, :, None, :]
    hs = _fma(state["h"], decay[..., None, None], outer)
    y = _fma(params["D"][None, :, None], x,
             _bmm(hs, Ch[..., None])[..., 0])
    state["h"].copy_(hs)
    state["conv"].copy_(hist[:, 1:])
    return _post(params, y.reshape(b, 1, -1), z[:, None], cfg,
                 compute_dtype)


def prefill_state(params, xin: torch.Tensor, cfg: SSDConfig,
                  compute_dtype=torch.bfloat16) -> tuple:
    """The full sequence: (the mixer's output, the final state), the
    convolution state being the last ``conv_width - 1`` pre-convolution
    inputs, zero-padded in front for a shorter prompt."""
    s = xin.shape[1]
    zxbcdt = linear.apply(params["in_proj"], xin, compute_dtype).to(
        torch.float32)
    out, ssd_state = _forward(params, zxbcdt, cfg, compute_dtype)
    _, xbc, _ = _split_proj(zxbcdt, cfg)
    cw = cfg.conv_width
    conv = (xbc[:, s - (cw - 1):] if s >= cw - 1 else
            torch.nn.functional.pad(xbc, (0, 0, cw - 1 - s, 0)))
    return out, {"h": ssd_state, "conv": conv.contiguous()}
