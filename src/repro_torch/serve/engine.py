"""Continuous-batching serve engine over the paged MX KV cache (port of
``repro.serve.engine``, the reference's default ragged step).

Every engine step packs each decode-ready sequence's pending token and
one prompt chunk per prefilling sequence into a (max_slots, W) row batch
and runs ONE ``model.ragged_step_paged`` over it: per layer, projections
and RoPE in PyTorch, then the ragged MX page-walk kernel, which
quantizes the rows' new K/V into their pages and attends over them.
Admission, prefix sharing, copy-on-write, swap preemption and EOS
recycling follow the reference exactly, so greedy token streams match
its ``ContinuousBatchingEngine`` under the same weights.

The page pools update in place: the reference's jitted step donates the
cache pytree and returns a new one instead.

Options of the reference's ``ServeConfig`` that this port does not run
yet (other step modes, einsum decode, monolithic prefill, speculation,
tiering, the mesh, overload control, temperature > 0) raise
``NotImplementedError`` at construction; none falls back silently.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import mx_attention_ragged_fused
from repro_torch.nn import model
from repro_torch.nn.config import ModelConfig

from . import kv_cache, sampling
from .sampling import SamplingParams
from .scheduler import Scheduler


@dataclasses.dataclass
class ServeConfig:
    """The reference's serving knobs, same names and defaults. The ones
    below the line select paths that are not ported yet: anything but
    their defaults raises ``NotImplementedError`` at construction. The
    reference's knobs that only those paths read (top-p/top-k/seed, the
    drafter, the tier policy, the monolithic path's trace cache and
    token budget) are left out."""

    max_seq: int = 1024
    eos_id: Optional[int] = None
    max_slots: int = 8
    page_size: int = 16
    num_pages: Optional[int] = None  # default: max_slots * pages_per_slot
    prefix_cache: bool = True
    admit_window: int = 4
    prefill_chunk: int = 64
    max_deferrals: int = 8
    # ---- not ported yet
    prefill_max_chunks: int = 1  # one prompt chunk per row and step
    temperature: float = 0.0  # 0 => greedy, the only ported sampler
    step_mode: str = "ragged"
    decode_kernel: str = "fused"
    prefill_mode: str = "chunked"
    spec_decode: bool = False
    tiered: bool = False
    mesh_shape: Optional[tuple] = None
    slo_ms: Optional[float] = None
    max_queue: Optional[int] = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_supported(cfg: ModelConfig, scfg: ServeConfig) -> None:
    if scfg.step_mode != "ragged":
        raise _unported(f"step_mode={scfg.step_mode!r}",
                        "A8 split step / A10 megakernel")
    if scfg.decode_kernel != "fused":
        raise _unported(f"decode_kernel={scfg.decode_kernel!r}",
                        "A8 einsum oracle")
    if scfg.prefill_mode != "chunked":
        raise _unported(f"prefill_mode={scfg.prefill_mode!r}",
                        "A8 monolithic prefill")
    if scfg.spec_decode:
        raise _unported("speculative decoding", "A7")
    if scfg.tiered:
        raise _unported("the tiered KV cache", "A6")
    if scfg.mesh_shape is not None:
        raise _unported("sharded serving (mesh_shape)", "A11")
    if scfg.slo_ms is not None or scfg.max_queue is not None:
        raise _unported("overload control (slo_ms / max_queue)", "A9")
    if scfg.temperature > 0:
        raise NotImplementedError(sampling.UNPORTED)
    if any(bd.mixer != "attn" for bd in cfg.all_blocks()):
        raise _unported("non-attention mixers", "A12")
    if not (cfg.quant.enabled and cfg.quant.quantize_kv_cache):
        raise _unported("a wide (non-MX) KV cache, which the reference "
                        "serves with its split step,", "A8")
    if scfg.prefill_max_chunks != 1:
        raise _unported("prefill_max_chunks > 1 (prefill token budgeting)",
                        "A5")
    if scfg.prefill_chunk <= 0:
        raise ValueError("prefill_chunk must be >= 1")


class ContinuousBatchingEngine:
    """Continuous batching over a paged MX KV cache on one device."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        _check_supported(cfg, serve_cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # either switch moves the bf16 rounding points of the dense
            # products (nn.linear._dot_rounded) away from the reference's
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = params
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        ps = serve_cfg.page_size
        pages_per_slot = kv_cache.pages_for(serve_cfg.max_seq, ps)
        self.num_pages = (serve_cfg.num_pages
                          or serve_cfg.max_slots * pages_per_slot)
        self.scheduler = Scheduler(
            max_slots=serve_cfg.max_slots, num_pages=self.num_pages,
            page_size=ps, max_seq=serve_cfg.max_seq,
            prefill_chunk=serve_cfg.prefill_chunk,
            prefix_cache=serve_cfg.prefix_cache,
            admit_window=serve_cfg.admit_window,
            max_deferrals=serve_cfg.max_deferrals)
        # one physical page beyond the scheduler's: the ragged kernel maps
        # -1 table entries (inactive rows, table tails) onto it
        self.cache = model.init_paged_cache(cfg, self.num_pages + 1, ps,
                                            self.device)
        self._width = serve_cfg.prefill_chunk
        self.steps = 0  # steps that decoded at least one token
        self.ragged_steps = 0  # model dispatches (one per engine step)
        self.kernel_launches = 0  # CUDA kernel launches over all steps
        self.kernel_launches_last_step = 0  # L per step on the card
        # host wall time of each ragged dispatch (sliding window)
        self.step_seconds: deque = deque(maxlen=4096)
        # smallest lead of a sampled token over its runner-up, in bf16 ulps
        # of its logit: how close the greedy decisions came to a tie
        self.min_top2_gap_ulps = float("inf")
        self.prompt_tokens = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0

    # -- internals ----------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _admit(self) -> None:
        sched = self.scheduler
        while True:
            seq = sched.admit_next()
            if seq is None:
                return
            if seq.req.swap is not None:
                # swapped-out sequence: restore the exact bytes of the
                # pages it owned alone into their fresh replacements
                snapshot, owned_idx, *_ = seq.req.swap
                seq.req.swap = None
                if owned_idx:
                    kv_cache.restore_seq(
                        self.cache, snapshot,
                        self._ids([seq.pages[i] for i in owned_idx]))
                continue
            # chunked admission binds the slot and pages; the prompt
            # streams through the ragged steps
            self.prompt_tokens += len(seq.req.prompt)

    def _swap_out(self, victim) -> None:
        """Preempt ``victim``: snapshot + free only the pages it owns
        alone; shared pages keep their other references."""
        sched = self.scheduler
        owned_idx, owned_ids = sched.exclusive_pages(victim)
        snapshot = None
        if owned_ids:
            snapshot = kv_cache.extract_seq(self.cache, self._ids(owned_ids))
        sched.preempt(victim, snapshot, owned_idx)

    def _reclaim_swapped_refs(self) -> bool:
        """Last resort: extract the shared pages queued swapped-out
        requests still pin into their snapshots and drop the references.
        Returns True if any reference was dropped."""
        sched = self.scheduler
        released = False
        for req in sched.queue:
            if req.swap is None:
                continue
            snapshot, owned_idx, pages, pos, cached, prefill_pos = req.swap
            owned = set(owned_idx)
            shared_idx = [i for i in range(len(pages)) if i not in owned]
            if not shared_idx:
                continue
            extra = kv_cache.extract_seq(
                self.cache, self._ids([pages[i] for i in shared_idx]))
            req.swap = (kv_cache.merge_snapshots(snapshot, extra),
                        owned_idx + shared_idx, pages, pos, cached,
                        prefill_pos)
            sched.pool.free([pages[i] for i in shared_idx])
            released = True
        return released

    def _relieve_pressure(self, seq) -> bool:
        """Swap out the youngest other sequence, else reclaim swapped
        requests' pinned shared pages. False: the pool is exhausted."""
        victim = self.scheduler.pick_victim(exclude=seq)
        if victim is not None:
            self._swap_out(victim)
            return True
        return self._reclaim_swapped_refs()

    def _alloc_one(self, seq) -> Optional[int]:
        while True:
            ids = self.scheduler.alloc_with_evict(1)
            if ids is not None:
                return ids[0]
            if not self._relieve_pressure(seq):
                return None

    def _ensure_pages(self) -> None:
        """Grow each decoding sequence's table for this step's token and
        give it sole ownership of the page it writes (copy-on-write)."""
        sched = self.scheduler
        ps = self.serve_cfg.page_size
        for seq in list(sched.decode_ready()):
            if sched.slots[seq.slot] is not seq:
                continue  # already preempted by an elder this pass
            while not sched.try_grow(seq, 1):
                if not self._relieve_pressure(seq):
                    raise RuntimeError(
                        "page pool exhausted for a lone sequence")
            wp = seq.pos // ps
            pid = seq.pages[wp]
            if sched.pool.ref(pid) > 1:
                new = self._alloc_one(seq)
                if new is None:
                    raise RuntimeError(
                        "page pool exhausted for a lone sequence")
                kv_cache.copy_page(self.cache, pid, new)
                sched.pool.free([pid])
                seq.pages[wp] = new
                sched.cow_copies += 1

    def _ragged_step(self) -> None:
        sched = self.scheduler
        self._ensure_pages()
        (tokens, row_start, seq_lens, logit_idx, page_rows, _modes,
         decode, prefill) = sched.assemble_ragged(self._width)
        if not decode and not prefill:
            return
        dev = self.device
        launches0 = mx_attention_ragged_fused.launches
        t0 = time.perf_counter()
        logits = model.ragged_step_paged(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(row_start, device=dev),
            torch.as_tensor(seq_lens, device=dev),
            torch.as_tensor(logit_idx, device=dev))
        toks = sampling.greedy(logits).cpu().numpy()  # syncs
        self.step_seconds.append(time.perf_counter() - t0)
        sampled = ([seq.slot for seq in decode]
                   + [seq.slot for seq, _, _, final in prefill if final])
        if sampled:
            gap = float(sampling.top2_gap_ulps(logits[sampled]).min())
            self.min_top2_gap_ulps = min(self.min_top2_gap_ulps, gap)
        self.kernel_launches_last_step = (mx_attention_ragged_fused.launches
                                          - launches0)
        self.kernel_launches += self.kernel_launches_last_step
        self.ragged_steps += 1
        if decode:
            self.steps += 1
        if prefill:
            self.prefill_chunks += len(prefill)
            self.prefill_tokens += int(sum(t[2] for t in prefill))
        eos = self.serve_cfg.eos_id
        for seq in decode:
            sched.advance(seq)
            sched.record_token(seq, int(toks[seq.slot]), eos_id=eos)
        for seq, st, real, final in prefill:
            seq.pos = st + real
            seq.prefill_pos = None if final else st + real
            if final:
                sched.register_prefix(seq)
                sched.record_token(seq, int(toks[seq.slot]), eos_id=eos)

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit what fits, then run one ragged step over every active
        sequence. Returns True if any work remains afterwards."""
        sched = self.scheduler
        self._admit()
        if not sched.active():
            if sched.queue and self._reclaim_swapped_refs():
                self._admit()  # pinned shared pages were the blocker
            if not sched.active():
                if sched.queue:
                    raise RuntimeError("scheduler stalled with queued work")
                return sched.has_work
        self._ragged_step()
        return sched.has_work

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run one full-width ragged step with every row inactive: all -1
        tables, so each layer's write lands on the trash page. The dense
        products' first launches and the allocator's growth then happen
        here rather than inside a timed run. No live page and no engine
        counter changes; the kernel wrapper's launch count does."""
        rows = self.serve_cfg.max_slots
        zeros = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        model.ragged_step_paged(
            self.params, self.cfg, self.cache,
            torch.zeros((rows, self._width), dtype=torch.long,
                        device=self.device),
            torch.full((rows, self.scheduler.pages_per_slot), -1,
                       dtype=torch.int32, device=self.device),
            zeros, zeros + 1, zeros)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               sampling_params: Optional[SamplingParams] = None) -> int:
        """Queue one request; returns its id. Use with :meth:`run`."""
        if sampling_params is not None:
            sampling_params.validate()  # raises for temperature > 0
        return self.scheduler.submit(prompt, max_new_tokens)

    def run(self) -> Dict[int, np.ndarray]:
        """Serve until drained. Returns {request_id: prompt + generated}."""
        while self.step():
            pass
        out = {}
        for req in self.scheduler.finished:
            out[req.id] = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
        self.scheduler.finished.clear()
        return out

    def cache_stats(self) -> Dict[str, float]:
        """Allocation, preemption, prefix-sharing and dispatch stats."""
        page_bytes = kv_cache.pool_page_nbytes(self.cache, self.num_pages + 1)
        sched = self.scheduler
        stats = {
            "allocated_bytes": kv_cache.cache_nbytes(self.cache),
            "page_bytes": page_bytes,
            "peak_pages": sched.peak_pages,
            "resident_tokens_at_peak": sched.resident_at_peak,
            "preemptions": sched.preemptions,
            "peak_paged_bytes": page_bytes * sched.peak_pages,
            "skipped_admissions": sched.skipped_admissions,
            "deferred_admissions": sched.deferred_admissions,
            "deferral_fallbacks": sched.deferral_fallbacks,
            "cow_copies": sched.cow_copies,
            "prompt_tokens": self.prompt_tokens,
            "prefill_tokens_computed": self.prefill_tokens,
            "prefix_hit_rate": (
                1.0 - self.prefill_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0),
            "prefill_chunks": self.prefill_chunks,
            "ragged_steps": self.ragged_steps,
            "decode_steps": self.steps,
            "kernel_launches": self.kernel_launches,
            "min_top2_gap_ulps": self.min_top2_gap_ulps,
        }
        if sched.prefix is not None:
            stats.update(sched.prefix.stats())
        return stats


# the default engine: continuous batching over the paged MX cache
ServeEngine = ContinuousBatchingEngine
