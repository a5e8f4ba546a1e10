"""Continuous-batching scheduler: admission, prefix sharing, chunked
prefill, preemption (port of ``repro.serve.scheduler``: the ragged step's
and the split step's batch assembly).

Host-side control plane: the device sees fixed-shape (max_slots, W) row
batches (ragged) or (max_slots, 1) decode batches (split) and a
(max_slots, pages_per_slot) page table while requests enter and leave
mid-stream.

  * **admission** — FCFS with a bounded skip-ahead window; with a prefix
    cache, the longest hit is retained into the request's page table
    first (page-aligned under chunked prefill; monolithic prefill, with
    ``prefill_chunk`` 0, also takes a hit that ends in a partial-page
    entry). Admission binds the slot and all of the prompt's pages; the
    prompt then streams through chunks (``prefill_pos``), or the engine
    prefills it whole at once (monolithic: ``pos`` is the prompt's
    length and ``prefill_pos`` None).
  * **deferral** — a request sharing an unregistered page-aligned head
    with a still-prefilling sequence waits (at most ``max_deferrals``
    attempts) until those pages register, so a shared-prefix burst
    shares pages instead of prefilling private copies.
  * **decode paging / preemption** — a sequence crossing a page boundary
    pulls a fresh page; a dry pool evicts LRU prefix leaves, then the
    engine swaps out the youngest other sequence (exact byte snapshot of
    the pages it owns alone; shared pages keep its reference).
  * **recycling** — EOS or max_new_tokens frees the slot and drops the
    sequence's page references the same step.
  * **speculation** — with ``num_draft_tokens`` K, a decode row becomes a
    verify window of 1 + K new tokens (the engine fills the draft
    columns); submission refuses a request whose last window would pass
    ``max_seq``.
  * **cancel** — between steps, a request is abandoned wherever it is
    (active, queued, swapped out) and every page reference it holds is
    dropped; ``on_token`` streams each recorded token to a consumer.

Each request carries its sampling parameters and resolved seed; its
stream counter is ``len(generated)``, which preemption and restore keep.

The scheduler never touches device memory.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from .kv_cache import PagePool, pages_for, pages_spanned
from .prefix_cache import PrefixCache


def _common_pages(a: np.ndarray, b: np.ndarray, page_size: int) -> int:
    """Whole pages of identical leading tokens between two prompts."""
    n = min(len(a), len(b))
    diff = np.flatnonzero(a[:n] != b[:n])
    common = int(diff[0]) if len(diff) else n
    return common // page_size


@dataclasses.dataclass
class Request:
    """One generation request; ``generated`` and ``swap`` survive
    preemption."""

    id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    # a sampling.SamplingParams (None: the engine's defaults) and the
    # resolved uint32 seed; sampling keys are (seed, len(generated))
    sampling: Optional[object] = None
    seed: int = 0
    # preemption snapshot: (cache_snapshot, owned_idx, pages, resident
    # tokens, cached_tokens, prefill_pos); owned_idx are the page-table
    # positions that were exclusively owned (extracted + freed), the rest
    # of ``pages`` stayed retained across the swap
    swap: Optional[tuple] = None
    deferred: bool = False  # deferral hit this request at least once
    defer_count: int = 0  # admission attempts deferral has cost it
    cancelled: bool = False

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def done(self) -> bool:
        return self.remaining <= 0


@dataclasses.dataclass
class ActiveSeq:
    """A request bound to a decode slot."""

    req: Request
    slot: int
    pos: int  # next cache write position == tokens currently resident
    pages: List[int]
    order: int  # admission sequence number (preemption picks the youngest)
    cached_tokens: int = 0  # prefix-cache hit at admission
    # next prompt chunk's start row; None once the prompt is resident
    prefill_pos: Optional[int] = None


class Scheduler:
    def __init__(self, *, max_slots: int, num_pages: int, page_size: int,
                 max_seq: int, prefill_chunk: int = 0,
                 prefill_max_chunks: int = 1,
                 prefix_cache: bool = False,
                 admit_window: int = 4, max_deferrals: int = 8,
                 num_draft_tokens: int = 0,
                 unit_budget: Optional[int] = None,
                 track_allocs: bool = False):
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_seq = max_seq
        # chunked prefill (0: monolithic): chunk starts stay page-aligned
        if prefill_chunk and prefill_chunk % page_size != 0:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a multiple of "
                f"page_size={page_size}: chunk starts must stay "
                "page-aligned so no page blends two chunks")
        self.prefill_chunk = prefill_chunk
        # chunks one prefilling sequence may take in one ragged step while
        # the batch is undersubscribed (prefill_allowed_chunks)
        if prefill_max_chunks < 1:
            raise ValueError("prefill_max_chunks must be >= 1")
        self.prefill_max_chunks = prefill_max_chunks
        self.pages_per_slot = pages_for(max_seq, page_size)
        if num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one max_seq={max_seq} "
                f"sequence (needs {self.pages_per_slot})")
        if admit_window < 1:
            raise ValueError("admit_window must be >= 1")
        self.admit_window = admit_window
        if num_draft_tokens < 0:
            raise ValueError("num_draft_tokens must be >= 0")
        # every verify step writes 1 + K rows: submission keeps the last
        # window inside max_seq's page table
        self.num_draft_tokens = num_draft_tokens
        if max_deferrals < 0:
            raise ValueError("max_deferrals must be >= 0")
        self.max_deferrals = max_deferrals
        self.pool = PagePool(num_pages, unit_budget=unit_budget,
                             track_allocs=track_allocs)
        self.prefix = (PrefixCache(self.pool, page_size)
                       if prefix_cache else None)
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[ActiveSeq]] = [None] * max_slots
        self.finished: List[Request] = []
        self._order = 0
        self._next_id = 0
        self.peak_pages = 0
        self.resident_at_peak = 0
        self.preemptions = 0
        self.skipped_admissions = 0
        self.cow_copies = 0
        self.deferred_admissions = 0
        self.deferral_fallbacks = 0
        self.cancellations = 0
        # streaming hook, called as on_token(request, token, finished)
        # after every recorded token (the async server's delivery path)
        self.on_token: Optional[Callable] = None

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               sampling=None, seed: int = 0) -> int:
        """Queue one request; invalid inputs fail here with a ValueError."""
        prompt = np.asarray(prompt)
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must be integer token ids, got dtype {prompt.dtype}")
        prompt = prompt.astype(np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if not isinstance(max_new_tokens, (int, np.integer)):
            raise ValueError("max_new_tokens must be an int, got "
                             f"{type(max_new_tokens).__name__}")
        if max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) "
                f"exceeds max_seq={self.max_seq}")
        if (self.num_draft_tokens
                and len(prompt) + max_new_tokens + self.num_draft_tokens
                > self.max_seq):
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) + "
                f"speculative draft window ({self.num_draft_tokens}) "
                f"exceeds max_seq={self.max_seq}: a verify step near the "
                f"end of this request would overflow its page table "
                f"(shrink num_draft_tokens or raise max_seq)")
        req = Request(self._next_id, prompt, int(max_new_tokens),
                      sampling=sampling, seed=int(seed))
        self._next_id += 1
        self.queue.append(req)
        return req.id

    def cancel(self, request_id: int) -> bool:
        """Abandon a request wherever it is; True if it was found.

        Cancel runs on the host between steps, so an active sequence
        (decoding, mid-prefill or mid-verify) holds no half-landed window:
        all its page references go in one ``pool.free`` (pages the prefix
        tree still holds stay cached) and its slot is released. A queued
        fresh request is dequeued. A queued swapped-out request already
        gave up the pages it owned alone at preemption: the shared
        references its swap tuple still pins are freed and the snapshot
        dropped. A finished or unknown id returns False.
        """
        for seq in self.active():
            if seq.req.id == request_id:
                self.pool.free(seq.pages)
                self.slots[seq.slot] = None
                self._mark_cancelled(seq.req)
                return True
        for qi, req in enumerate(self.queue):
            if req.id != request_id:
                continue
            if req.swap is not None:
                _snapshot, owned_idx, pages, *_ = req.swap
                owned = set(owned_idx)
                shared = [p for i, p in enumerate(pages) if i not in owned]
                if shared:
                    self.pool.free(shared)
                req.swap = None
            del self.queue[qi]
            self._mark_cancelled(req)
            return True
        return False

    def _mark_cancelled(self, req: Request) -> None:
        req.cancelled = True
        self.cancellations += 1

    # -- admission / eviction ----------------------------------------------

    def active(self) -> List[ActiveSeq]:
        return [s for s in self.slots if s is not None]

    def prefilling(self) -> List[ActiveSeq]:
        """Active sequences still streaming prompt chunks, oldest first."""
        return sorted((s for s in self.active()
                       if s.prefill_pos is not None),
                      key=lambda s: s.order)

    def decode_ready(self) -> List[ActiveSeq]:
        """Active sequences with a pending token (prefill complete)."""
        return [s for s in self.active() if s.prefill_pos is None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting prefix-tree leaves only when
        that can cover the shortfall (a doomed allocation must not
        destroy cached prefixes for nothing)."""
        if not self.pool.can_alloc(n) and self.prefix is not None:
            shortfall = n - self.pool.free_pages
            if self.prefix.evictable_count() >= shortfall:
                self.prefix.evict(shortfall)
        return self.pool.alloc(n)

    def _try_admit(self, req: Request, slot: int) -> Optional[ActiveSeq]:
        """Bind ``req`` to ``slot`` if its pages fit; None leaves no trace."""
        if req.swap is not None:
            _snapshot, owned_idx, pages, pos0, cached, prefill_pos = req.swap
            ids = self.alloc_with_evict(len(owned_idx))
            if ids is None:
                return None
            pages = list(pages)
            for i, pid in zip(owned_idx, ids):
                pages[i] = pid
        else:
            if req.generated:
                raise RuntimeError("mid-stream request without snapshot")
            hit, cached = [], 0
            if self.prefix is not None:
                # chunks start on page boundaries, so chunked prefill takes
                # page-aligned hits only; monolithic admission also takes a
                # partial last page (the engine copies it and installs the
                # tail's rows in place)
                hit, cached = self.prefix.acquire(
                    req.prompt, full_only=bool(self.prefill_chunk))
            if (self.prefill_chunk and self.prefix is not None
                    and req.defer_count < self.max_deferrals):
                # a prompt sharing an unregistered page-aligned head with a
                # sequence still streaming chunks waits until those pages
                # register, then shares them instead of prefilling a
                # private copy; bounded, so a stalled leader cannot
                # starve it
                cap = (len(req.prompt) - 1) // self.page_size
                for s in self.prefilling():
                    shared = min(_common_pages(req.prompt, s.req.prompt,
                                               self.page_size), cap)
                    if shared * self.page_size > cached:
                        if hit:
                            self.pool.free(hit)
                        if not req.deferred:
                            req.deferred = True
                            self.deferred_admissions += 1
                        req.defer_count += 1
                        if req.defer_count == self.max_deferrals:
                            self.deferral_fallbacks += 1
                        return None
            ids = self.alloc_with_evict(
                pages_for(len(req.prompt), self.page_size) - len(hit))
            if ids is None:
                if hit:
                    self.pool.free(hit)  # drop the lookup's references
                return None
            pages = hit + ids
            if self.prefix is not None:
                self.prefix.record_lookup(cached)
            if self.prefill_chunk:
                # only the prefix hit is resident so far; the tail streams
                # through chunks
                pos0, prefill_pos = cached, cached
            else:
                pos0, prefill_pos = len(req.prompt), None
        seq = ActiveSeq(req=req, slot=slot, pos=pos0, pages=pages,
                        order=self._order, cached_tokens=cached,
                        prefill_pos=prefill_pos)
        self._order += 1
        self.slots[slot] = seq
        return seq

    def admit_next(self) -> Optional[ActiveSeq]:
        """Admit the queue head, or the first of up to ``admit_window - 1``
        younger requests that fits when the head does not."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots or not self.queue:
            return None
        for qi in range(min(self.admit_window, len(self.queue))):
            seq = self._try_admit(self.queue[qi], free_slots[0])
            if seq is not None:
                del self.queue[qi]
                if qi:
                    self.skipped_admissions += 1
                return seq
        return None

    def register_prefix(self, seq: ActiveSeq) -> None:
        """Insert ``seq``'s full prompt pages into the radix tree once
        their bytes are resident; monolithic prefill also registers the
        prompt's partial last page (chunked prefill cannot use it)."""
        if self.prefix is not None:
            self.prefix.insert(seq.req.prompt, seq.pages,
                               partial=not self.prefill_chunk)

    def try_grow(self, seq: ActiveSeq, num_tokens: int = 1) -> bool:
        """Grow ``seq``'s page table to cover ``num_tokens`` rows written
        at ``seq.pos`` (1 for decode, 1 + K for a verify window);
        all-or-nothing."""
        need = pages_spanned(seq.pos, num_tokens, self.page_size) \
            - len(seq.pages)
        if need <= 0:
            return True
        ids = self.alloc_with_evict(need)
        if ids is None:
            return False
        seq.pages.extend(ids)
        return True

    def pick_victim(self, exclude: ActiveSeq) -> Optional[ActiveSeq]:
        """Youngest other active sequence (FCFS: elders keep their slots)."""
        victims = [s for s in self.active() if s is not exclude]
        return max(victims, key=lambda s: s.order) if victims else None

    def exclusive_pages(self, seq: ActiveSeq):
        """(table indices, page ids) of the pages only ``seq`` references."""
        idx = [i for i, p in enumerate(seq.pages) if self.pool.ref(p) == 1]
        return idx, [seq.pages[i] for i in idx]

    def preempt(self, victim: ActiveSeq, snapshot,
                owned_idx: List[int]) -> None:
        """Swap out ``victim``: free its exclusive pages, requeue at front."""
        self.pool.free([victim.pages[i] for i in owned_idx])
        self.slots[victim.slot] = None
        victim.req.swap = (snapshot, owned_idx, list(victim.pages),
                           victim.pos, victim.cached_tokens,
                           victim.prefill_pos)
        self.queue.appendleft(victim.req)
        self.preemptions += 1

    def advance(self, seq: ActiveSeq) -> None:
        """The step wrote ``seq``'s pending token at ``seq.pos``."""
        seq.pos += 1

    def record_token(self, seq: ActiveSeq, token: int, eos_id=None) -> bool:
        """Append a sampled token; finish + recycle on EOS/max_new.
        Returns True if the sequence is still active."""
        seq.req.generated.append(int(token))
        finished = seq.req.done or (eos_id is not None
                                    and int(token) == eos_id)
        if finished:
            self.pool.free(seq.pages)
            self.slots[seq.slot] = None
            self.finished.append(seq.req)
        if self.on_token is not None:
            self.on_token(seq.req, int(token), finished)
        return not finished

    # -- per-step batch assembly -------------------------------------------

    def prefill_allowed_chunks(self) -> int:
        """Prefill chunks one sequence may take this step: up to
        ``prefill_max_chunks`` while the batch is undersubscribed (fewer
        active sequences than slots), exactly one once every slot is
        taken. That is the starvation bound: decode rows are never
        displaced, and a prefilling sequence advances at least one chunk a
        step."""
        if len(self.active()) < self.max_slots:
            return self.prefill_max_chunks
        return 1

    def planned_prefill_real(self, seq: ActiveSeq, width: int) -> int:
        """Valid prompt tokens ``seq``'s next ragged bite will carry:
        ``min(min(chunk, width) * allowed, width)``, ``allowed`` from
        :meth:`prefill_allowed_chunks`, capped at the prompt's remainder.
        The one source of the formula for ``assemble_ragged`` and for the
        tiered engine's write-marking pre-pass, which must mark exactly the
        pages the step writes."""
        chunk = min(self.prefill_chunk, width)
        bite = min(chunk * self.prefill_allowed_chunks(), width)
        return min(bite, len(seq.req.prompt) - seq.prefill_pos)

    def assemble_ragged(self, width: int, extra_tokens: int = 0):
        """One packed (max_slots, width) row batch for the ragged step.

        Returns (tokens, row_start, seq_lens, logit_idx, page_rows, modes,
        decode, prefill): ``row_start``/``seq_lens`` bound each row's new
        positions (inactive rows: 0 / 1 with an all -1 table, so their
        write lands on the trash page); a decode row carries its pending
        token and ``extra_tokens`` draft columns the engine fills (a
        verify window); ``logit_idx`` is the first row whose logits the
        host reads; ``modes`` is 0 inactive, 1 decode or verify, 2 prefill
        chunk; ``prefill`` lists ``(seq, start, real, final)``.
        """
        ns, pps = self.max_slots, self.pages_per_slot
        tokens = np.zeros((ns, width), np.int32)
        row_start = np.zeros((ns,), np.int32)
        seq_lens = np.ones((ns,), np.int32)
        logit_idx = np.zeros((ns,), np.int32)
        modes = np.zeros((ns,), np.int32)
        page_rows = np.full((ns, pps), -1, np.int32)
        decode = self.decode_ready()
        for seq in decode:
            if not seq.req.generated:
                raise RuntimeError("active sequence with no pending token")
            tokens[seq.slot, 0] = seq.req.generated[-1]
            row_start[seq.slot] = seq.pos
            seq_lens[seq.slot] = seq.pos + 1 + extra_tokens
            modes[seq.slot] = 1
            page_rows[seq.slot, : len(seq.pages)] = seq.pages
        prefill = []
        for seq in self.prefilling():
            st = seq.prefill_pos
            real = self.planned_prefill_real(seq, width)
            if real <= 0:
                continue
            tokens[seq.slot, :real] = seq.req.prompt[st:st + real]
            row_start[seq.slot] = st
            seq_lens[seq.slot] = st + real
            final = st + real == len(seq.req.prompt)
            logit_idx[seq.slot] = real - 1 if final else 0
            modes[seq.slot] = 2
            page_rows[seq.slot, : len(seq.pages)] = seq.pages
            prefill.append((seq, st, real, final))
        self._sample_peak()
        return (tokens, row_start, seq_lens, logit_idx, page_rows, modes,
                decode, prefill)

    def assemble(self, extra_tokens: int = 0):
        """Fixed-shape numpy batch for the split step's decode or verify
        dispatch.

        Returns (tokens (NS, 1 + extra_tokens), pos (NS,), page_rows
        (NS, P), active): column 0 is each slot's pending token, the
        engine fills the draft columns; inactive rows, and sequences still
        streaming their prompt, are token 0 / pos 0 / pages -1 (their
        writes drop, their logits are ignored).
        """
        ns, pps = self.max_slots, self.pages_per_slot
        tokens = np.zeros((ns, 1 + extra_tokens), np.int32)
        pos = np.zeros((ns,), np.int32)
        page_rows = np.full((ns, pps), -1, np.int32)
        act = self.decode_ready()
        for seq in act:
            if not seq.req.generated:
                raise RuntimeError("active sequence with no pending token")
            tokens[seq.slot, 0] = seq.req.generated[-1]
            pos[seq.slot] = seq.pos
            page_rows[seq.slot, : len(seq.pages)] = seq.pages
        self._sample_peak()
        return tokens, pos, page_rows, act

    def _sample_peak(self) -> None:
        """Peak pages in use and the tokens resident then, sampled at each
        step's assembly: decode-ready sequences are about to write their
        pending token (+1), prefilling ones count the chunks that landed.
        A strict new peak resets the resident count; a tie keeps the
        smaller one (the larger bytes per token)."""
        resident = int(sum(s.pos + (1 if s.prefill_pos is None else 0)
                           for s in self.active()))
        if self.pool.pages_in_use > self.peak_pages:
            self.peak_pages = self.pool.pages_in_use
            self.resident_at_peak = resident
        elif self.pool.pages_in_use == self.peak_pages:
            self.resident_at_peak = (resident if self.resident_at_peak == 0
                                     else min(self.resident_at_peak, resident))
