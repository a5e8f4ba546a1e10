"""Speculative decoding: draft proposals and greedy acceptance (port of
``repro.serve.spec_decode``; host-side numpy, as in the reference).

Each verify step feeds a sequence's pending token plus K drafted tokens
through one pass over the paged MX cache: the ragged step's rows of
1 + K new tokens, or the split step's ``model.verify_step_paged`` at
Tq = 1 + K. Acceptance is ``sampling.verify_rejection``: at temperature 0
the longest draft prefix equal to the model's argmax targets plus one
bonus token, so greedy streams equal non-speculative decode for any
drafter; a drafter changes only how many tokens a step emits.

Rollback is by position: rejected drafts' K/V rows sit in pages the
sequence owns alone (the engine copies shared pages of the write window
first), past the accepted position, dead by masking until the next write
there overwrites them.

  * :class:`NgramDrafter` -- prompt-lookup drafting: continue the most
    recent earlier occurrence of the history's tail n-gram.
  * :class:`ScriptedDrafter` -- deterministic pseudo-random drafts from a
    seed, the adversarial drafter of the tests.
"""
from __future__ import annotations

import numpy as np


class Drafter:
    """Interface: propose ``k`` draft tokens continuing ``history``."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """history: (S,) int32 prompt + generated tokens so far (the last
        entry is the pending token the verify step feeds first). Returns
        (k,) int32 draft tokens. Must be deterministic per (history, k):
        the engine may be replayed against a reference run."""
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: continue the most recent n-gram match.

    Scans for the latest earlier occurrence of the history's tail
    ``n``-gram (longest ``n`` first, ``max_ngram`` down to
    ``min_ngram``) and proposes the ``k`` tokens that followed that
    occurrence; repetitive histories make these near-perfect drafts. No
    match (or a match at the very end with nothing following) falls back
    to repeating the last token — acceptance then just degrades, never
    correctness.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32)
        out = np.full((k,), h[-1], np.int32)  # fallback: repeat last
        for n in range(min(self.max_ngram, len(h) - 1), self.min_ngram - 1,
                       -1):
            # all candidate windows at once (one vectorized pass — this
            # runs on the host every verify step, so O(S) python loops
            # would grow drafting latency with generation length)
            wins = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.nonzero((wins == h[-n:]).all(axis=1))[0]
            if len(hits):
                start = int(hits[-1])  # most recent earlier occurrence
                cont = h[start + n:start + n + k]
                out[:len(cont)] = cont
                if 0 < len(cont) < k:
                    out[len(cont):] = cont[-1]
                return out
        return out


class ScriptedDrafter(Drafter):
    """Deterministic pseudo-random drafts — the adversarial test drafter.

    Proposals depend only on (seed, history, k), so a run can be replayed
    exactly. Mostly-wrong drafts exercise the rollback path every step;
    occasional accidental hits (small ``vocab``) exercise partial
    acceptance.
    """

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = int(vocab)
        self.seed = int(seed)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int64)
        mix = int((h.sum() * 2654435761 + len(h) * 97 + self.seed)
                  % (2 ** 31))
        rng = np.random.default_rng(mix)
        return rng.integers(0, self.vocab, size=(k,)).astype(np.int32)


def resolve_drafter(spec, vocab_size: int) -> Drafter:
    """ServeConfig.drafter -> Drafter instance ("ngram" | instance)."""
    if isinstance(spec, Drafter):
        return spec
    if spec == "ngram":
        return NgramDrafter()
    raise ValueError(f"unknown drafter {spec!r} (expected 'ngram' or a "
                     "Drafter instance)")


def greedy_accept(drafts: np.ndarray, targets: np.ndarray):
    """Longest accepted draft prefix + the tokens to emit.

    ``targets[j]`` is the model's greedy next token after fed token ``j``
    (j = 0 is the pending token, j >= 1 the drafts). Draft ``i`` is
    accepted iff every earlier draft was and ``drafts[i] == targets[i]``
    — i.e. the draft matches what greedy decode would have produced at
    that position. Returns ``(accepted, emitted)`` where ``emitted =
    targets[:accepted + 1]``: the accepted drafts *are* those targets,
    and the final entry is the bonus token the model predicts after them
    (so every verify step emits >= 1 token and the stream equals
    non-speculative greedy decode exactly).
    """
    drafts = np.asarray(drafts)
    targets = np.asarray(targets)
    k = len(drafts)
    a = 0
    while a < k and drafts[a] == targets[a]:
        a += 1
    return a, targets[:a + 1]
