"""Token sampling (port of ``repro.serve.sampling``): the reference's
counter-based threefry streams, temperature / top-k / top-p filtering and
lossless rejection-sampling verification of speculative drafts.

Every function is batch-row independent and runs in plain PyTorch on the
device that holds the logits, so one step samples a batch that mixes
greedy and stochastic rows at different temperatures.

RNG contract (the reference's): every sampled token is a pure function of
``(seed, counter)``, ``counter`` being the token's index in its own
request's stream. Keys are ``fold_in(fold_in(PRNGKey(seed), counter),
salt)``, never split from a shared stream, so a request's tokens do not
depend on its slot, its neighbours or its preemptions.

The threefry part is integer arithmetic and equals ``jax.random`` bit for
bit: :func:`prng_key`, :func:`fold_in`, :func:`random_bits` (jax's
partitionable layout, ``jax_threefry_partitionable=True``: each element's
counter is its 64-bit flat index split into (hi, lo), and its bits are the
two threefry words XORed) and :func:`uniform` (the mantissa trick). Words
are uint32 values held in int64 tensors (or numpy arrays, for the keys
made on the host) masked to 32 bits, because CUDA supports
``torch.uint32`` arithmetic only in part. The float part (log,
exp, softmax, cumsum) follows the reference's formulas, but its last bits
are torch's, not XLA's: a decision whose margin is below a few ulps can
go the other way (the tests measure those margins).

Filtering: ``temperature`` scales the logits (``<= 0`` means the exact f32
argmax, first index on ties); ``top_k`` keeps the k highest (0 disables,
ties by index through a stable sort); ``top_p`` keeps the top-k survivors
whose exclusive prefix mass is below p. Verification accepts a draft x
with probability p(x) of that filtered distribution and on rejection draws
from it with x removed and renormalized, so speculation emits tokens with
exactly the probabilities plain sampling has; at temperature 0 it is the
exact greedy prefix match.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# fold_in salts separating the independent uses of one (seed, counter)
# position: the sample, the acceptance uniform and the residual draw
_SALT_SAMPLE = 0x1
_SALT_ACCEPT = 0x2
_SALT_RESIDUAL = 0x3

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (the reference's).

    ``temperature <= 0`` selects exact greedy decoding. ``seed=None`` asks
    the engine to derive a per-request seed from its base seed and the
    request id; an explicit seed makes the stream reproducible.
    """

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: Optional[int] = None

    def validate(self) -> "SamplingParams":
        if not np.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.seed is not None and not isinstance(
                self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an int, got {type(self.seed)}")
        return self


def resolve_seed(params: SamplingParams, base_seed: int,
                 request_id: int) -> int:
    """The uint32 seed a request samples with: its own seed, else one mixed
    from the engine's base seed and the request id."""
    if params.seed is not None:
        return int(params.seed) & _MASK
    return (int(base_seed) * 0x9E3779B1 + int(request_id) * 0x85EBCA77
            + 0x165667B1) & _MASK


# ---------------------------------------------------------------------------
# threefry2x32, as jax.random computes it
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """The 20-round threefry2x32 hash of counters (x0, x1) under key
    (k0, k1); every argument int64 words in [0, 2^32), tensors or numpy
    arrays, broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(x, like=None):
    """Integers ``x`` as uint32 words in int64: a tensor on ``like``'s
    device when ``like`` is a tensor, else a numpy array."""
    if isinstance(like, torch.Tensor):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x).astype(np.int64))
        return x.to(like.device, torch.int64) & _MASK
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64) & _MASK


def _stack(words: list):
    xp = torch if isinstance(words[0], torch.Tensor) else np
    return xp.stack(words, -1)


def prng_key(seeds):
    """``jax.random.PRNGKey`` of uint32 seeds: (...,) -> (..., 2) keys
    ``[0, seed]`` (threefry_seed of a 32-bit seed); a tensor of seeds
    gives tensor keys on its device, anything else numpy keys."""
    s = _words(seeds, seeds)
    return _stack([s * 0, s])


def fold_in(keys, data):
    """``jax.random.fold_in``: (..., 2) keys and data (broadcast, any
    integers taken as uint32) -> (..., 2) keys, the threefry of each key
    over the counter pair ``[0, data]``; tensor or numpy, as ``keys``
    are. The engine makes its keys in numpy on the host (a few hundred
    integer operations on a handful of words cost less there than as
    device launches) and draws only the noise over the vocabulary on the
    logits' device."""
    d = _words(data, keys)
    return _stack(list(threefry2x32(keys[..., 0], keys[..., 1], d * 0, d)))


def split(key, num: int = 2):
    """``jax.random.split`` of one (2,) key into (num, 2) keys (jax's
    partitionable layout: key i is the threefry of the counter pair
    ``[0, i]``, which is ``fold_in(key, i)``); tensor or numpy, as
    ``key`` is."""
    xp = torch if isinstance(key, torch.Tensor) else np
    return fold_in(key, xp.arange(num))


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of ``shape`` under each key: (..., 2)
    keys -> (..., *shape) int64 words. Element i's counters are the hi and
    lo words of its flat index, and its bits the two outputs XORed."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = idx >> 32, idx & _MASK
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits of each word as the
    mantissa of a float in [1, 2), minus 1, scaled, then ``max(minval,
    .)``. (..., 2) keys -> (..., *shape) f32."""
    bits = random_bits(keys, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = float(np.float32(minval))  # the bounds and their span in f32
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in f32: -log(-log(u)) of a
    uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> tuple:
    """``jax.random.categorical`` over the last axis of (N, V) f32 logits,
    under (N, 2) keys, one a row, or one (2,) key drawing the whole (N,
    V) noise: ((N,) argmax of the perturbed scores logits + gumbel, (N,)
    how far each pick won: the gap between the top two scores, inf where
    one is finite)."""
    scores = gumbel(keys, logits.shape[keys.dim() - 1:]) + logits
    drawn = torch.argmax(scores, dim=-1)
    top2 = scores.topk(2, dim=-1).values
    return drawn, top2[:, 0] - top2[:, 1]


def _base_keys(seeds, counters) -> np.ndarray:
    """(N,) seeds x (N,) counters -> (N, 2) counter-derived keys,
    ``fold_in(PRNGKey(seed), counter)``, in numpy on the host."""
    return fold_in(prng_key(_words(seeds)), counters)


# ---------------------------------------------------------------------------
# filtering, sampling and verification
# ---------------------------------------------------------------------------


def filter_logits(logits: torch.Tensor, temps: torch.Tensor,
                  top_ps: torch.Tensor, top_ks: torch.Tensor) -> torch.Tensor:
    """Temperature, top-k and top-p filtering, batch-row independent.

    logits (N, V); temps / top_ps (N,) f32, top_ks (N,) int. Returns (N, V)
    f32 with everything outside the kept set at -inf. Greedy rows get
    temperature 1 (callers argmax their raw logits instead).
    """
    x = logits.to(torch.float32)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    x = x / safe_t
    # the reference's stable double argsort: rank 0 = largest logit, ties
    # by index order; the second argsort of a permutation is its inverse
    order = torch.argsort(-x, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(x.shape[-1], device=x.device).expand_as(order))
    ks = top_ks.to(ranks.dtype)[:, None]
    keep_k = (ks <= 0) | (ranks < ks)
    x = torch.where(keep_k, x, -torch.inf)
    # nucleus over the top-k survivors: keep while the exclusive prefix
    # mass is below p (always keeps the top-1 token)
    probs = torch.softmax(x, dim=-1)
    sorted_probs = torch.take_along_dim(probs, order, dim=-1)
    excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep_sorted = excl < top_ps[:, None]
    keep_p = torch.take_along_dim(keep_sorted, ranks, dim=-1)
    return torch.where(keep_k & keep_p, x, -torch.inf)


def sample(logits: torch.Tensor, temps, top_ps, top_ks, seeds,
           counters, with_lead: bool = False):
    """One token per row: logits (N, V); per-row parameter vectors as in
    :func:`filter_logits` plus seeds (N,) uint32 values and counters (N,)
    each row's index in its request's stream (arrays or tensors, on any
    device: the keys are made on the host). Greedy rows (temp <= 0)
    return the exact f32 argmax. Returns (N,) int64 tokens, and with
    ``with_lead`` also the lead of each row's winning perturbed score
    (:func:`categorical`; inf for greedy rows)."""
    lf32 = logits.to(torch.float32)
    greedy_rows = temps <= 0
    filtered = filter_logits(lf32, temps, top_ps, top_ks)
    keys = torch.from_numpy(fold_in(_base_keys(seeds, counters),
                                    _SALT_SAMPLE)).to(lf32.device)
    drawn, lead = categorical(keys, filtered)
    toks = torch.where(greedy_rows, torch.argmax(lf32, dim=-1), drawn)
    if not with_lead:
        return toks
    return toks, torch.where(greedy_rows, torch.inf, lead)


def _remove_and_renorm(probs: torch.Tensor, token: torch.Tensor,
                       remove: torch.Tensor) -> torch.Tensor:
    """Residual distribution: zero ``token``'s mass where ``remove`` and
    renormalize; rows left with no mass fall back to their argmax one-hot."""
    v = probs.shape[-1]
    hot = torch.nn.functional.one_hot(token.long(), v).to(probs.dtype)
    resid = torch.where(remove[:, None], probs * (1.0 - hot), probs)
    total = resid.sum(dim=-1, keepdim=True)
    fallback = torch.nn.functional.one_hot(
        torch.argmax(probs, dim=-1), v).to(probs.dtype)
    return torch.where(total > 0, resid / torch.clamp(total, min=1e-38),
                       fallback)


def verify_rejection(logits: torch.Tensor, drafts: torch.Tensor, temps,
                     top_ps, top_ks, seeds, counters, margins: bool = False):
    """Speculative acceptance for one verify step, the reference's.

    logits (N, K+1, V): position j's next-token logits after feeding token
    j (j = 0 the pending token, j >= 1 the drafts); drafts (N, K); per-row
    parameters as in :func:`sample`, ``counters`` the stream index of the
    first token this step may emit. Greedy rows accept the longest prefix
    of drafts equal to the argmax targets; stochastic rows accept draft j
    when ``u_j < p_j(draft)`` (u from fold_in(fold_in(key, j), ACCEPT)),
    then draw the last token from the residual at the first rejection or
    from p_K after K acceptances (fold_in(fold_in(key, acc), RESIDUAL)).

    Returns ``(num_emitted (N,), emitted (N, K+1))`` int64: row n emits
    ``emitted[n, :num_emitted[n]]``, entries past it are 0. With
    ``margins`` also the two decisions' distances from flipping (inf on
    greedy rows): ``(|u - p(draft)| / p(draft) (N, K) f32, the final
    draw's perturbed lead (N,))``; a relative error of p below the first
    cannot flip an acceptance test.
    """
    n, t, v = logits.shape
    k = t - 1
    dev = logits.device
    lf32 = logits.to(torch.float32)
    targets = torch.argmax(lf32, dim=-1)  # (N, T) greedy targets
    greedy_rows = temps <= 0

    def rep(a):
        return torch.repeat_interleave(a, t)
    filtered = filter_logits(lf32.reshape(n * t, v), rep(temps),
                             rep(top_ps), rep(top_ks)).reshape(n, t, v)
    probs = torch.softmax(filtered, dim=-1)

    # the keys of stream positions 0 .. K, on the host: (N, T, 2)
    steps = fold_in(_base_keys(seeds, counters)[:, None, :], np.arange(t))
    u = uniform(torch.from_numpy(fold_in(steps[:, :k], _SALT_ACCEPT))).to(
        dev)  # (N, K)
    d = drafts.to(dev).long()
    p_draft = torch.take_along_dim(probs[:, :k], d[..., None],
                                   dim=-1)[..., 0]
    accept = torch.where(greedy_rows[:, None], d == targets[:, :k],
                         u < p_draft)
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # (N,) in [0, K]

    # the last emitted token: residual draw at the first rejection, bonus
    # draw after K acceptances (no removal), argmax target when greedy
    rows = torch.arange(n, device=dev)
    probs_a = probs[rows, acc]
    draft_a = torch.cat([d, torch.zeros((n, 1), dtype=d.dtype, device=dev)],
                        dim=1)[rows, acc]
    resid = _remove_and_renorm(probs_a, draft_a, acc < k)
    last_keys = torch.from_numpy(fold_in(steps, _SALT_RESIDUAL)).to(
        dev)[rows, acc]
    resid_logits = torch.log(torch.clamp(resid, min=1e-38)) + torch.where(
        resid > 0, 0.0, -torch.inf)
    drawn, lead = categorical(last_keys, resid_logits)
    final = torch.where(greedy_rows, targets[rows, acc], drawn)

    cols = torch.arange(t, device=dev)[None, :]
    padded = torch.cat([d, torch.zeros((n, 1), dtype=d.dtype, device=dev)],
                       dim=1)
    # greedy rows emit the targets (== drafts on the accepted prefix),
    # stochastic rows the accepted drafts
    emitted = torch.where(cols < acc[:, None],
                          torch.where(greedy_rows[:, None], targets, padded),
                          torch.zeros_like(padded))
    emitted[rows, acc] = final
    if not margins:
        return acc + 1, emitted
    gap = torch.where(greedy_rows[:, None] | (p_draft <= 0), torch.inf,
                      (u - p_draft).abs() / p_draft)
    return acc + 1, emitted, (gap, torch.where(greedy_rows, torch.inf, lead))


def slot_arrays(max_slots: int) -> dict:
    """Neutral per-slot parameter arrays (greedy, seed 0, counter 0);
    padding rows stay greedy and their tokens are discarded."""
    return {
        "temps": np.zeros((max_slots,), np.float32),
        "top_ps": np.ones((max_slots,), np.float32),
        "top_ks": np.zeros((max_slots,), np.int32),
        "seeds": np.zeros((max_slots,), np.uint32),
        "counters": np.zeros((max_slots,), np.int32),
    }


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(N, V) logits -> (N,) int64 argmax in f32, first index on ties."""
    return torch.argmax(logits.to(torch.float32), dim=-1)


def top2_gap_ulps(logits: torch.Tensor) -> torch.Tensor:
    """(N, V) logits -> (N,) lead of each row's top logit over its
    runner-up, in bf16 ulps of the top logit (logits are bf16 values, so
    a gap of 0 is an exact tie)."""
    top2 = logits.to(torch.float32).topk(2, dim=-1).values
    exponent = torch.frexp(top2[:, 0].abs()).exponent
    return (top2[:, 0] - top2[:, 1]) / torch.ldexp(
        torch.ones_like(top2[:, 0]), exponent - 8)
