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

With ``ServeConfig.tiered`` the pool is the reference's tiered
mixed-format cache: new pages land hot in the base fp8 format, pages no
step has written for ``TierPolicy.hot_steps`` / ``cold_steps`` steps are
repacked in place down the ladder (``kernels.mx_repack_pages``) under a
per-step page budget, and the pool is metered in quarter-page units, so
narrower pages buy resident tokens. The per-page format ids live on the
host (``page_fmts``) with a device mirror that every layer's ragged
kernel reads, and they travel with a page's bytes through swap-out,
restore and copy-on-write.

The page pools update in place: the reference's jitted step donates the
cache pytree and returns a new one instead.

Options of the reference's ``ServeConfig`` that this port does not run
yet (other step modes, einsum decode, monolithic prefill, speculation,
the mesh, overload control, temperature > 0) raise
``NotImplementedError`` at construction; none falls back silently.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.formats import FORMAT_BY_ID, FORMAT_IDS
from repro_torch.kernels import mx_attention_ragged_fused, mx_repack_pages
from repro_torch.nn import model
from repro_torch.nn.config import ModelConfig

from . import kv_cache, sampling
from .kv_cache import PAGE_UNITS_FULL, UNITS_BY_BITS
from .sampling import SamplingParams
from .scheduler import Scheduler

#: element bit width per MX format name (drives quarter-page unit costs)
_FMT_BITS = {"fp8_e4m3": 8, "fp8_e5m2": 8, "fp6_e3m2": 6, "fp6_e2m3": 6,
             "fp4_e2m1": 4}


@dataclasses.dataclass
class TierPolicy:
    """Hot/cold tiering knobs for the mixed-format KV page pool (the
    reference's, same names and defaults).

    A page is *hot* while a step wrote it within the last ``hot_steps``
    steps; past that the background repack moves it down the ladder
    (base fp8 -> ``mid_fmt`` -> ``cold_fmt``, the latter after
    ``cold_steps``), at most ``repack_pages_per_step`` pages per step, in
    dispatches of ``repack_list_len`` listed pages.
    """

    mid_fmt: str = "fp6_e3m2"  # first demotion step (3/4 of a page)
    cold_fmt: str = "fp4_e2m1"  # final demotion step (1/2 of a page)
    hot_steps: int = 8  # steps since last write before base -> mid
    cold_steps: int = 32  # steps since last write before mid -> cold
    repack_pages_per_step: int = 4  # background repack budget per step
    repack_list_len: int = 8  # page-list length of one repack dispatch


@dataclasses.dataclass
class ServeConfig:
    """The reference's serving knobs, same names and defaults. The ones
    below the line select paths that are not ported yet: anything but
    their defaults raises ``NotImplementedError`` at construction. The
    reference's knobs that only those paths read (top-p/top-k/seed, the
    drafter, the monolithic path's trace cache and token budget) are
    left out. ``tiered`` reinterprets ``num_pages`` as the fp8-equivalent
    byte budget (``num_pages * 4`` quarter-page units) over a physical
    pool twice that size."""

    max_seq: int = 1024
    eos_id: Optional[int] = None
    max_slots: int = 8
    page_size: int = 16
    num_pages: Optional[int] = None  # default: max_slots * pages_per_slot
    prefix_cache: bool = True
    admit_window: int = 4
    prefill_chunk: int = 64
    max_deferrals: int = 8
    tiered: bool = False
    tier_policy: Optional[TierPolicy] = None
    # ---- not ported yet
    prefill_max_chunks: int = 1  # one prompt chunk per row and step
    temperature: float = 0.0  # 0 => greedy, the only ported sampler
    step_mode: str = "ragged"
    decode_kernel: str = "fused"
    prefill_mode: str = "chunked"
    spec_decode: bool = False
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


def _validate_tiering(cfg: ModelConfig, scfg: ServeConfig,
                      tp: TierPolicy) -> None:
    """The reference's tiering checks, with its messages."""
    if scfg.decode_kernel != "fused":
        raise ValueError(
            "tiered KV cache requires decode_kernel='fused': the "
            "einsum gather path dequantizes without per-page formats")
    if scfg.prefill_mode != "chunked" or any(
            bd.mixer != "attn" for bd in cfg.all_blocks()):
        raise ValueError(
            "tiered KV cache requires chunked prefill on an "
            "attention-only model: the monolithic gather path reads "
            "pages without per-page formats")
    if not cfg.quant.quantize_kv_cache:
        raise ValueError("tiered KV cache requires quantize_kv_cache")
    if _FMT_BITS.get(cfg.quant.fmt) != 8:
        raise ValueError(
            f"tiered KV cache needs an 8-bit base KV format (new "
            f"writes land full-width), got {cfg.quant.fmt!r}")
    for name, fmt in (("mid_fmt", tp.mid_fmt), ("cold_fmt", tp.cold_fmt)):
        if fmt not in FORMAT_IDS:
            raise ValueError(f"unknown tier {name} {fmt!r}")
    if not (_FMT_BITS[cfg.quant.fmt] > _FMT_BITS[tp.mid_fmt]
            >= _FMT_BITS[tp.cold_fmt]):
        raise ValueError(
            f"tier ladder must narrow monotonically, got "
            f"{cfg.quant.fmt} -> {tp.mid_fmt} -> {tp.cold_fmt}")
    if tp.hot_steps < 1 or tp.cold_steps < tp.hot_steps:
        raise ValueError(
            "tier_policy needs hot_steps >= 1 and "
            "cold_steps >= hot_steps")
    if tp.repack_pages_per_step < 0 or tp.repack_list_len < 1:
        raise ValueError(
            "tier_policy needs repack_pages_per_step >= 0 and "
            "repack_list_len >= 1")


class ContinuousBatchingEngine:
    """Continuous batching over a paged MX KV cache on one device."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        self.tiered = bool(serve_cfg.tiered)
        self.tier = None
        if self.tiered:
            # checked first, so tiering's rejections keep the reference's
            # ValueErrors rather than the unported paths' errors
            self.tier = serve_cfg.tier_policy or TierPolicy()
            _validate_tiering(cfg, serve_cfg, self.tier)
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
        unit_budget = None
        if self.tiered:
            # num_pages is the fp8-equivalent byte budget; the physical
            # pool over-provisions 2x so narrower pages buy residency
            unit_budget = self.num_pages * PAGE_UNITS_FULL
            self.num_pages *= 2
        self.scheduler = Scheduler(
            max_slots=serve_cfg.max_slots, num_pages=self.num_pages,
            page_size=ps, max_seq=serve_cfg.max_seq,
            prefill_chunk=serve_cfg.prefill_chunk,
            prefix_cache=serve_cfg.prefix_cache,
            admit_window=serve_cfg.admit_window,
            max_deferrals=serve_cfg.max_deferrals,
            unit_budget=unit_budget, track_allocs=self.tiered)
        # one physical page beyond the scheduler's: the ragged kernel maps
        # -1 table entries (inactive rows, table tails) onto it
        self.cache = model.init_paged_cache(cfg, self.num_pages + 1, ps,
                                            self.device, tiered=self.tiered)
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
        # tiered pool state, on the host: one format id and last-write
        # tick per physical page (trash page included), shared by every
        # layer like the page table, with a device mirror for the kernels
        self._tick = 0  # advances first in every step(); drives page ages
        self._mixed_fmts = None
        if self.tiered:
            tp = self.tier
            self._mixed_fmts = tuple(dict.fromkeys(
                (cfg.quant.fmt, tp.mid_fmt, tp.cold_fmt)))
            self._base_fmt_id = FORMAT_IDS[cfg.quant.fmt]
            self.page_fmts = np.full((self.num_pages + 1,),
                                     self._base_fmt_id, np.int32)
            self._page_fmts_dev = torch.as_tensor(self.page_fmts,
                                                  device=self.device)
            self._fmts_dirty = False
            self._last_write = np.zeros((self.num_pages + 1,), np.int64)
            # swap snapshots carry raw bytes: the owned pages' format ids
            # travel beside them, keyed by request id
            self._swap_fmts: Dict[int, list] = {}
            self.repacked_pages = 0
            self.repack_dispatches = 0
            self.max_repacked_in_step = 0
            self._repacked_this_step = 0

    # -- internals ----------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    # -- tiered mixed-format pool -------------------------------------------

    def _sync_fmts(self) -> torch.Tensor:
        """Device mirror of the per-page format ids (refreshed on change)."""
        if self._fmts_dirty:
            self._page_fmts_dev = torch.as_tensor(self.page_fmts,
                                                  device=self.device)
            self._fmts_dirty = False
        return self._page_fmts_dev

    def _drain_allocs(self) -> None:
        """Reset every page allocated since the last drain to the base
        format and mark it written now: a recycled page that was repacked
        narrow must not keep its stale id under fresh fp8 bytes."""
        if not self.tiered:
            return
        for pid in self.scheduler.pool.alloc_log:
            if self.page_fmts[pid] != self._base_fmt_id:
                self.page_fmts[pid] = self._base_fmt_id
                self._fmts_dirty = True
            self._last_write[pid] = self._tick
        self.scheduler.pool.alloc_log.clear()

    def _mark_write(self, pids) -> None:
        """This step writes rows into ``pids``: they stay hot."""
        if self.tiered:
            for pid in pids:
                self._last_write[pid] = self._tick

    def _set_page_fmt(self, pid: int, fmt: str) -> None:
        """Flip one page's format id and unit cost (after its repack); every
        holder of the page reads the one shared id."""
        self.page_fmts[pid] = FORMAT_IDS[fmt]
        self._fmts_dirty = True
        self.scheduler.pool.set_cost(pid, UNITS_BY_BITS[_FMT_BITS[fmt]])

    def _repack_pages_to(self, pids, dst_fmt: str) -> None:
        """Requantize ``pids`` (current formats per ``page_fmts``) to
        ``dst_fmt`` in place, in dispatches of ``repack_list_len`` listed
        pages (padding repeats the last live page; the kernel skips it).
        One dispatch launches the repack once per layer pool."""
        ll = self.tier.repack_list_len
        bs = min(self.cfg.quant.block_size, self.cfg.head_dim)
        for lo in range(0, len(pids), ll):
            group = pids[lo:lo + ll]
            ids = group + [group[-1]] * (ll - len(group))
            fmts = [int(self.page_fmts[p]) for p in ids]
            ids_t = torch.as_tensor(ids, dtype=torch.int32,
                                    device=self.device)
            fmts_t = torch.as_tensor(fmts, dtype=torch.int32,
                                     device=self.device)
            for pool in self.cache:
                mx_repack_pages(
                    pool["k_elems"], pool["k_scales"], pool["v_elems"],
                    pool["v_scales"], ids_t, fmts_t, len(group),
                    dst_fmt_name=dst_fmt, mixed_fmts=self._mixed_fmts,
                    block_size=bs)
            self.repack_dispatches += 1
            for pid in group:
                self._set_page_fmt(pid, dst_fmt)
            self.repacked_pages += len(group)
            self._repacked_this_step += len(group)

    def _protected_pages(self) -> set:
        """Pages the tiering pass must not touch this step: a prefilling
        sequence's pages from its resume point on, and every decode-ready
        sequence's write page."""
        sched = self.scheduler
        ps = self.serve_cfg.page_size
        protected = set()
        for seq in sched.prefilling():
            protected.update(seq.pages[seq.prefill_pos // ps:])
        for seq in sched.decode_ready():
            lo = seq.pos // ps
            protected.update(seq.pages[lo:min(len(seq.pages), lo + 1)])
        return protected

    def _run_repack(self) -> None:
        """One background tiering pass: demote aged pages down the ladder
        under the per-step budget, cold candidates before mid ones, each
        oldest first (a stable sort over ascending page ids)."""
        if not self.tiered or self.tier.repack_pages_per_step <= 0:
            return
        self._drain_allocs()
        tp, pool = self.tier, self.scheduler.pool
        protected = self._protected_pages()
        mid_id = FORMAT_IDS[tp.mid_fmt]
        cold_id = FORMAT_IDS[tp.cold_fmt]
        to_mid, to_cold = [], []
        for pid in range(self.num_pages):  # never the trash page
            if pool.ref(pid) == 0 or pid in protected:
                continue
            age = self._tick - int(self._last_write[pid])
            fmt = int(self.page_fmts[pid])
            if fmt == self._base_fmt_id and age >= tp.hot_steps:
                to_mid.append((age, pid))
            elif fmt == mid_id and mid_id != cold_id \
                    and age >= tp.cold_steps:
                to_cold.append((age, pid))
        budget = tp.repack_pages_per_step
        self._repacked_this_step = 0
        for cands, dst in ((to_cold, tp.cold_fmt), (to_mid, tp.mid_fmt)):
            if budget <= 0 or not cands:
                continue
            cands.sort(key=lambda t: -t[0])  # oldest first
            take = [pid for _, pid in cands[:budget]]
            self._repack_pages_to(take, dst)
            budget -= len(take)
        self.max_repacked_in_step = max(self.max_repacked_in_step,
                                        self._repacked_this_step)

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
                if self.tiered:
                    # the restored bytes keep their narrow encodings: put
                    # back the ids they were extracted with (drain first:
                    # the fresh pages were just reset to the base format)
                    self._drain_allocs()
                    saved = self._swap_fmts.pop(seq.req.id, None)
                    if saved is not None:
                        for i, fid in zip(owned_idx, saved):
                            self._set_page_fmt(seq.pages[i],
                                               FORMAT_BY_ID[fid])
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
        if self.tiered:
            self._swap_fmts[victim.req.id] = [
                int(self.page_fmts[p]) for p in owned_ids]
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
            if self.tiered:
                self._swap_fmts.setdefault(req.id, []).extend(
                    int(self.page_fmts[pages[i]]) for i in shared_idx)
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
                src_fmt = (int(self.page_fmts[pid])
                           if self.tiered else None)
                new = self._alloc_one(seq)
                if new is None:
                    raise RuntimeError(
                        "page pool exhausted for a lone sequence")
                kv_cache.copy_page(self.cache, pid, new)
                sched.pool.free([pid])
                seq.pages[wp] = new
                sched.cow_copies += 1
                if self.tiered and src_fmt != self._base_fmt_id:
                    # the copy inherited a narrow encoding, and this
                    # step's write lands fp8 bytes: promote the copy to
                    # the base format first (widening is lossless)
                    self._drain_allocs()
                    self._set_page_fmt(new, FORMAT_BY_ID[src_fmt])
                    self._repack_pages_to(
                        [new], FORMAT_BY_ID[self._base_fmt_id])
        if self.tiered:
            self._drain_allocs()
            for seq in sched.decode_ready():
                if sched.slots[seq.slot] is not seq:
                    continue
                self._mark_write(seq.pages[seq.pos // ps:seq.pos // ps + 1])

    def _tier_args(self) -> dict:
        if not self.tiered:
            return {}
        return dict(page_fmts=self._sync_fmts(),
                    mixed_fmts=self._mixed_fmts)

    def _ragged_step(self) -> None:
        sched = self.scheduler
        self._ensure_pages()
        if self.tiered:
            # mark the pages this step's prefill rows write, by the same
            # formula assemble_ragged is about to apply
            self._drain_allocs()
            ps = self.serve_cfg.page_size
            for seq in sched.prefilling():
                st = seq.prefill_pos
                real = sched.planned_prefill_real(seq, self._width)
                if real > 0:
                    self._mark_write(
                        seq.pages[st // ps: (st + real - 1) // ps + 1])
        (tokens, row_start, seq_lens, logit_idx, page_rows, _modes,
         decode, prefill) = sched.assemble_ragged(self._width)
        if not decode and not prefill:
            return
        dev = self.device
        tier_args = self._tier_args()
        launches0 = mx_attention_ragged_fused.launches
        t0 = time.perf_counter()
        logits = model.ragged_step_paged(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(row_start, device=dev),
            torch.as_tensor(seq_lens, device=dev),
            torch.as_tensor(logit_idx, device=dev), **tier_args)
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
        """Admit what fits, run the tiering pass, then one ragged step over
        every active sequence (the reference's order: tick, admit, repack,
        step). Returns True if any work remains afterwards."""
        sched = self.scheduler
        self._tick += 1
        self._admit()
        if not sched.active():
            if sched.queue and self._reclaim_swapped_refs():
                self._admit()  # pinned shared pages were the blocker
            if not sched.active():
                if sched.queue:
                    raise RuntimeError("scheduler stalled with queued work")
                return sched.has_work
        self._run_repack()
        self._ragged_step()
        return sched.has_work

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run one full-width ragged step with every row inactive: all -1
        tables, so each layer's write lands on the trash page. The dense
        products' first launches and the allocator's growth then happen
        here rather than inside a timed run. No live page, no page format
        or age and no engine counter changes; the kernel wrapper's launch
        count does."""
        rows = self.serve_cfg.max_slots
        zeros = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        model.ragged_step_paged(
            self.params, self.cfg, self.cache,
            torch.zeros((rows, self._width), dtype=torch.long,
                        device=self.device),
            torch.full((rows, self.scheduler.pages_per_slot), -1,
                       dtype=torch.int32, device=self.device),
            zeros, zeros + 1, zeros, **self._tier_args())
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
        if self.tiered:
            pool = sched.pool
            for fmt in self._mixed_fmts:
                fid = FORMAT_IDS[fmt]
                stats[f"pages_{fmt}"] = sum(
                    1 for pid in range(self.num_pages)
                    if pool.ref(pid) > 0 and self.page_fmts[pid] == fid)
            stats.update({
                "unit_budget": pool.unit_budget,
                "units_in_use": pool.units_in_use,
                "peak_units": pool.peak_units,
                "repacked_pages": self.repacked_pages,
                "repack_dispatches": self.repack_dispatches,
                "max_repacked_in_step": self.max_repacked_in_step,
            })
        if sched.prefix is not None:
            stats.update(sched.prefix.stats())
        return stats


# the default engine: continuous batching over the paged MX cache
ServeEngine = ContinuousBatchingEngine
