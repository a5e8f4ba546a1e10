"""Serving engines (port of ``repro.serve.engine``): the
continuous-batching engine over the paged KV cache, with the ragged step
and the split step, and the fixed-slot engine over contiguous caches.

``step_mode="ragged"`` (the default) packs each decode-ready sequence's
pending token and one prompt chunk per prefilling sequence into a
(max_slots, W) row batch and runs ONE ``model.ragged_step_paged`` over
it: per layer, projections and RoPE in PyTorch, then the ragged MX
page-walk kernel, which quantizes the rows' new K/V into their pages and
attends over them. ``step_mode="megakernel"`` runs the same step with the
whole layer stack in one kernel launch (``model.megakernel_step_paged``
over stacked weights and pools); configurations it cannot serve fall
back to the per-layer ragged step, or to split, with the reference's
reasons and log line. ``step_mode="split"``, the reference's own oracle,
runs the separate dispatches instead: prefill chunks under a per-step
token budget, round-robin across prefilling sequences, each batch one
``model.prefill_chunk_paged`` (the chunked-prefill kernel); then one
``model.decode_step_paged`` over the decode-ready slots (host-side K/V
writes, then the decode page walk, or the einsum gather oracle with
``decode_kernel="einsum"``). As in the reference, configurations the
ragged step cannot serve -- ``decode_kernel="einsum"``, a wide bf16 KV
cache -- fall back to split at construction, with a log line; the
choice is ``cache_stats()["step_mode"]``. Admission, prefix sharing,
copy-on-write, swap preemption and EOS recycling follow the reference
exactly, so greedy token streams match its ``ContinuousBatchingEngine``
under the same weights, in either mode.

With ``ServeConfig.tiered`` the pool is the reference's tiered
mixed-format cache: new pages land hot in the base fp8 format, pages no
step has written for ``TierPolicy.hot_steps`` / ``cold_steps`` steps are
repacked in place down the ladder (``kernels.mx_repack_pages``) under a
per-step page budget, and the pool is metered in quarter-page units, so
narrower pages buy resident tokens. The per-page format ids live on the
host (``page_fmts``) with a device mirror that every layer's kernels
read, and they travel with a page's bytes through swap-out, restore and
copy-on-write.

Sampling follows the reference's per-slot vectors (temperature, top-p,
top-k, seed, stream counter): each row's token is a pure function of its
request's seed and its index in the request's stream
(``serve.sampling``), sampled in PyTorch on the device beside the
logits; a batch of greedy rows alone takes the exact argmax.
``spec_decode`` drafts K tokens a decode row (``serve.spec_decode``) and
verifies them in the same step: the ragged step feeds verify windows of
1 + K new tokens and reads their 1 + K logits rows (``num_logits``); the
split step runs ``model.verify_step_paged`` at Tq = 1 + K. Acceptance is
``sampling.verify_rejection``; the write window's shared pages are copied
first, and rejected drafts roll back by position alone.

The serving front end's hooks are the reference's: ``submit`` passes
the overload gate (``serve.overload``, armed by ``ServeConfig.slo_ms`` /
``max_queue``; a shed raises ``ShedError``) and each request's first
sampled token feeds the gate's estimates and ``admission_latencies``;
``cancel`` abandons a request wherever it is; ``save_prefix_cache`` /
``load_prefix_cache`` persist the prefix tree with the exact bytes of its
pages (tiered: their formats too) in the reference's npz layout, so a
snapshot passes between the two packages and between step modes.

``prefill_mode="monolithic"`` admits each request with one dense
prefill (``model.prefill``, or ``model.prefill_with_prefix`` over a
prefix hit, which may end mid-page in a partial-page entry: the shared
partial page is copied first and the tail's rows land at its offset) and
installs the prefill's contiguous cache into the request's pages; as in
the reference it turns the ragged step off and decodes through the split
step's dispatches, with a log line. ``FixedSlotEngine``, the reference's
golden engine, prefills a fixed batch densely and decodes it with one
shared position over contiguous ring-buffer caches
(``model.decode_step``); ``generate`` is the batch API of both engines.
MLA models (deepseek-v2-lite) are served by ``FixedSlotEngine`` alone,
over their latent caches: the continuous engine refuses them with the
reference's message, as their caches have no page layout there. Models
with recurrent mixers (RG-LRU, SSD: recurrentgemma-2b, mamba2-780m) are
served by both engines: the paged cache keeps one state row a slot per
recurrent layer, a monolithic prefill installs the prompt's final state
into its slot's row, the split step's decode steps every row, and a
swap-out carries the row with the sequence's pages into whatever slot
readmits it. As in the reference, speculation raises for them, the
prefix cache turns off, chunked prefill falls back to monolithic
admission and the ragged and megakernel steps to the split dispatches,
each with its log line, and tiering raises.
As in the reference, no engine serves codebook heads (musicgen): the
continuous engine refuses them with the reference's message and
``FixedSlotEngine.generate`` takes (B, S0) prompts alone; musicgen runs
through the model functions (``model.prefill``, ``decode_step`` and the
paged steps).

The page pools update in place: the reference's jitted steps donate the
cache pytree and return a new one instead. The reference bounds its
per-length jitted prefill traces with an LRU (``prefill_trace_cache``);
PyTorch runs eagerly, so the port has no traces to bound and no knob.

The reference's ragged-aware prefill budgeting runs as it does there:
with ``prefill_max_chunks`` above 1 a prefilling row takes up to that many
chunks in one ragged or megakernel step while fewer sequences are active
than slots (``Scheduler.prefill_allowed_chunks``), the ragged width being
``prefill_chunk * prefill_max_chunks``; the split step and monolithic
admission ignore it. The one option of the reference's ``ServeConfig``
that this port does not run yet (the mesh) raises ``NotImplementedError``
at construction; none falls back silently.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import MXTensor
from repro_torch.core.formats import FORMAT_BY_ID, FORMAT_IDS
from repro_torch.kernels import (mx_attention_prefill_fused,
                                 mx_attention_ragged_fused,
                                 mx_attention_verify_fused,
                                 mx_megakernel_step, mx_repack_pages)
from repro_torch.nn import blocks, model
from repro_torch.nn import common as C
from repro_torch.nn.config import ModelConfig

from . import kv_cache, sampling, spec_decode
from .kv_cache import PAGE_UNITS_FULL, UNITS_BY_BITS
from .overload import OverloadConfig, OverloadController
from .sampling import SamplingParams
from .scheduler import Scheduler

log = logging.getLogger(__name__)

#: the kernels of the engine steps (the page walks and the megakernel),
#: whose launches a step counts
_ATTN_KERNELS = (mx_attention_ragged_fused, mx_attention_verify_fused,
                 mx_attention_prefill_fused, mx_megakernel_step)

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
    reference's bound on the monolithic path's jitted traces
    (``prefill_trace_cache``) has nothing to bound here and is left out.
    ``tiered`` reinterprets ``num_pages`` as the
    fp8-equivalent byte budget (``num_pages * 4`` quarter-page units) over
    a physical pool twice that size."""

    max_seq: int = 1024
    # default sampling of requests without their own SamplingParams:
    # temperature 0 is the exact greedy argmax, top_k 0 is off; ``seed``
    # is the base seed mixed with each request id (sampling.resolve_seed)
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    max_slots: int = 8
    page_size: int = 16
    num_pages: Optional[int] = None  # default: max_slots * pages_per_slot
    prefix_cache: bool = True
    admit_window: int = 4
    # "chunked" streams each prompt through prefill_chunk-token chunks in
    # the engine steps; "monolithic" prefills it whole at admission (dense
    # attention, then an install into its pages) and decodes through the
    # split step
    prefill_mode: str = "chunked"
    prefill_chunk: int = 64
    # the split step's prefill tokens per engine step, spent round-robin
    # across prefilling sequences in whole chunks (default: one chunk)
    prefill_token_budget: Optional[int] = None
    max_deferrals: int = 8
    tiered: bool = False
    tier_policy: Optional[TierPolicy] = None
    # "ragged" (one dispatch a step), "megakernel" (that dispatch's whole
    # layer stack as one kernel launch) or "split" (the reference's oracle:
    # prefill-chunk dispatches, then one decode dispatch); configurations
    # the megakernel cannot serve fall back to ragged, and those the ragged
    # step cannot serve to split
    step_mode: str = "ragged"
    # the split step's attention: "fused" (the MX page-walk kernels) or
    # "einsum" (the gather oracle; a wide bf16 cache always takes it)
    decode_kernel: str = "fused"
    # speculative decoding: draft num_draft_tokens a decode row and verify
    # them in the same step (sampling.verify_rejection: greedy prefix
    # match at temperature 0, rejection sampling above); ``drafter`` is
    # "ngram" or a spec_decode.Drafter
    spec_decode: bool = False
    num_draft_tokens: int = 4
    drafter: object = "ngram"
    # overload control (serve.overload): shed submissions once the
    # predicted first-token latency passes slo_ms or the queue holds
    # max_queue requests; None for either leaves it off
    slo_ms: Optional[float] = None
    max_queue: Optional[int] = None
    # ragged-aware prefill budgeting: how many chunks one prefilling
    # sequence may advance in a single ragged step while the batch is
    # undersubscribed (fewer active sequences than slots); the ragged width
    # grows to prefill_chunk * prefill_max_chunks, and a full batch drops
    # back to one chunk a step, so resident decoders are never starved.
    # The split step and monolithic admission ignore it. 1: one chunk
    prefill_max_chunks: int = 1
    # ---- not ported yet
    mesh_shape: Optional[tuple] = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


#: the mixers the continuous engine serves: attention through page pools,
#: the recurrent mixers through per-slot state rows
_PAGED_MIXERS = {"attn", "rglru", "ssd"}


def _check_mixers(cfg: ModelConfig) -> None:
    """The reference's refusal of mixers that have no paged cache there
    (MLA: FixedSlotEngine serves it), checked first as there, then of
    codebook heads (musicgen), which no engine of the reference serves."""
    unpaged = {bd.mixer for bd in cfg.all_blocks()} - _PAGED_MIXERS
    if unpaged:
        raise NotImplementedError(
            f"continuous batching does not support mixers {unpaged} "
            "— use FixedSlotEngine (launch/serve.py --engine fixed)")
    if cfg.num_codebooks > 1:
        raise NotImplementedError(
            "continuous batching with codebook heads is a follow-on")


def _check_supported(cfg: ModelConfig, scfg: ServeConfig,
                     chunked: bool) -> None:
    """The reference's ValueErrors for unknown settings, then a
    NotImplementedError naming the ROADMAP item of each unported path.
    ``chunked``: whether the engine streams prompts in chunks (the chunk
    settings are checked only then, as in the reference)."""
    if scfg.decode_kernel not in ("einsum", "fused"):
        raise ValueError(
            f"unknown decode_kernel {scfg.decode_kernel!r} "
            "(expected 'fused' or 'einsum')")
    if scfg.prefill_mode not in ("chunked", "monolithic"):
        raise ValueError(
            f"unknown prefill_mode {scfg.prefill_mode!r} "
            "(expected 'chunked' or 'monolithic')")
    if chunked:
        if scfg.prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be >= 1")
        if scfg.prefill_token_budget is not None \
                and scfg.prefill_token_budget <= 0:
            raise ValueError("prefill_token_budget must be >= 1")
    if scfg.step_mode not in ("ragged", "split", "megakernel"):
        raise ValueError(
            f"unknown step_mode {scfg.step_mode!r} "
            "(expected 'ragged', 'split' or 'megakernel')")
    if scfg.prefill_max_chunks < 1:
        raise ValueError("prefill_max_chunks must be >= 1")
    if scfg.spec_decode:
        if scfg.num_draft_tokens < 1:
            raise ValueError("spec_decode needs num_draft_tokens >= 1")
        spec_decode.resolve_drafter(scfg.drafter, cfg.vocab_size)
    SamplingParams(temperature=scfg.temperature, top_p=scfg.top_p,
                   top_k=scfg.top_k).validate()
    if scfg.mesh_shape is not None:
        raise _unported("sharded serving (mesh_shape)", "A7")


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


def _sample(logits: torch.Tensor, key, temperature: float) -> torch.Tensor:
    """The fixed-slot engine's pick from the last logits row of (B, S, V)
    ``logits``: the exact f32 argmax at temperature <= 0, else a
    categorical draw of ``logits / temperature`` under the one threefry
    ``key`` over the whole (B, V) batch, as ``jax.random.categorical``."""
    logits = logits[:, -1].to(torch.float32)
    if temperature <= 0:
        return sampling.greedy(logits)
    keys = torch.as_tensor(np.asarray(key, np.int64), device=logits.device)
    return sampling.categorical(keys, logits / temperature)[0]


class FixedSlotEngine:
    """A fixed batch of slots sharing one position (the reference's golden
    engine): one dense ``model.prefill`` of the whole (B, S0) batch into
    contiguous caches of ``serve_cfg.max_seq`` positions, then one
    ``model.decode_step`` a token. Runs on the card unless ``device`` is
    the CPU; ``params`` live on that device."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.device = torch.device(device)
        C.exact_cuda_products(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 key=None) -> np.ndarray:
        """prompts (B, S0) int32 -> (B, S0 + max_new_tokens) int32. At
        temperature > 0 the first token draws under ``key`` (default
        ``PRNGKey(0)``, two uint32 words) and each later one under the
        second half of a ``split`` of the running key, as the
        reference. Prompts of another rank (codebook frames (B, S0, CB))
        raise ``ValueError``, as the reference's unpacking of their
        shape does: no engine serves codebook heads."""
        key = sampling.prng_key(0) if key is None else np.asarray(key)
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim != 2:
            raise ValueError(
                f"FixedSlotEngine.generate takes (B, S0) prompts; got shape "
                f"{prompts.shape}")
        toks = torch.as_tensor(prompts, device=self.device).long()
        s0 = toks.shape[1]
        temp = self.serve_cfg.temperature
        logits, cache = model.prefill(self.params, self.cfg, toks,
                                      max_seq=self.serve_cfg.max_seq)
        out = [toks]
        tok = _sample(logits, key, temp)
        for i in range(max_new_tokens):
            out.append(tok[:, None])
            if i == max_new_tokens - 1:
                break
            key, sub = sampling.split(key)
            logits, cache = model.decode_step(self.params, self.cfg, cache,
                                              tok[:, None], s0 + i)
            tok = _sample(logits, sub, temp)
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


class ContinuousBatchingEngine:
    """Continuous batching over a paged MX KV cache on one device."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        _check_mixers(cfg)
        # the reference's fallbacks for recurrent mixers, whose state has
        # no pages: speculation raises (checked before tiering, as there),
        # the prefix cache turns off, chunked prefill falls back to
        # monolithic admission, the ragged and megakernel steps to the
        # split dispatches, and tiering raises (_validate_tiering)
        recurrent = sorted({bd.mixer for bd in cfg.all_blocks()} - {"attn"})
        if (serve_cfg.spec_decode and serve_cfg.num_draft_tokens >= 1
                and recurrent):
            raise NotImplementedError(
                f"speculative decoding requires attention-only models, "
                f"got mixers {recurrent}: recurrent state has no position "
                "axis to roll rejected drafts back through")
        self.tiered = bool(serve_cfg.tiered)
        self.tier = None
        if self.tiered:
            # checked first, so tiering's rejections keep the reference's
            # ValueErrors rather than the unported paths' errors
            self.tier = serve_cfg.tier_policy or TierPolicy()
            _validate_tiering(cfg, serve_cfg, self.tier)
        # prefix sharing needs K/V pages alone: a recurrent state is not a
        # pure function of a paged token prefix
        self.prefix_enabled = bool(serve_cfg.prefix_cache and not recurrent)
        if serve_cfg.prefix_cache and not self.prefix_enabled:
            log.info("prefix cache disabled: mixers %s are not "
                     "attention-only", recurrent)
        # chunked prefill streams prompts through the page pools, and a
        # recurrent state has no chunk to resume from
        self.chunked = serve_cfg.prefill_mode == "chunked" and not recurrent
        if serve_cfg.prefill_mode == "chunked" and not self.chunked:
            log.info("chunked prefill disabled: mixers %s are not "
                     "attention-only; using monolithic prefill", recurrent)
        _check_supported(cfg, serve_cfg, self.chunked)
        self.device = torch.device(device)
        C.exact_cuda_products(self.device)
        self.params = params
        self.cfg = cfg
        # monolithic prefill builds full-length (non-ring) caches: slot ==
        # absolute position, so a prompt's cache reshapes into its pages
        self.cfg_prefill = cfg.replace(serve_full_cache=True)
        # the split step's attention path, as the reference sets it
        self.cfg_decode = cfg.replace(decode_kernel=serve_cfg.decode_kernel)
        self.serve_cfg = serve_cfg
        # speculation: K drafts a decode row, verified in the same step
        self.spec_enabled = bool(serve_cfg.spec_decode)
        self._k = serve_cfg.num_draft_tokens if self.spec_enabled else 0
        self.drafter = (spec_decode.resolve_drafter(serve_cfg.drafter,
                                                    cfg.vocab_size)
                        if self.spec_enabled else None)
        # requests without their own SamplingParams sample with these
        self._default_sampling = SamplingParams(
            temperature=serve_cfg.temperature, top_p=serve_cfg.top_p,
            top_k=serve_cfg.top_k).validate()
        # the admission gate; with neither knob set it only keeps stats
        self.overload = OverloadController(OverloadConfig(
            slo_ms=serve_cfg.slo_ms, max_queue=serve_cfg.max_queue))
        # submit -> first sampled token, in host seconds (sliding window)
        self._submit_time: Dict[int, float] = {}
        self.admission_latencies: deque = deque(maxlen=4096)
        # the reference's ladder, decided here once from the configuration:
        # the one-dispatch ragged step needs attention-only mixers, the
        # fused kernel, an MX pool and chunked prefill (monolithic
        # admission dispatches outside the step); anything else runs the
        # split dispatches
        ragged_ok = (not recurrent and serve_cfg.decode_kernel == "fused"
                     and cfg.quant.enabled and cfg.quant.quantize_kv_cache
                     and self.chunked)
        # "megakernel" is the ragged step with its layer stack fused, so
        # it inherits every ragged prerequisite
        ragged_like = serve_cfg.step_mode in ("ragged", "megakernel")
        self.ragged = ragged_like and ragged_ok
        if ragged_like and not self.ragged:
            log.info("ragged step disabled: needs attention-only mixers, "
                     "decode_kernel='fused', a quantized KV cache and "
                     "chunked prefill; using split dispatches")
        # the reference's megakernel ladder: any rung that fails drops to
        # the per-layer ragged step (or split) with a log line; a CUDA
        # build or launch failure is no rung, it raises
        self.megakernel = False
        self._megakernel_fallback_reason = None
        if serve_cfg.step_mode == "megakernel":
            if not self.ragged:
                reason = ("ragged prerequisites unmet (the megakernel is "
                          "the ragged step fused over layers)")
            elif serve_cfg.mesh_shape is not None:
                # unreachable while _check_supported refuses meshes (A7)
                reason = ("sharded mesh — megakernel under shard_map is a "
                          "follow-on (see ROADMAP)")
            elif any(isinstance(leaf, MXTensor)
                     for leaf in _param_leaves(params)):
                reason = ("MXTensor (pre-quantized) weights — the "
                          "megakernel pre-quantizes wide masters itself")
            else:
                reason = blocks.megakernel_reject_reason(cfg)
            if reason is None:
                self.megakernel = True
            else:
                self._megakernel_fallback_reason = reason
                log.info("megakernel step disabled: %s; falling back to "
                         "the %s step", reason,
                         "per-layer ragged" if self.ragged
                         else "split-dispatch")
        # the ragged kernel maps -1 table entries (inactive rows, table
        # tails) onto a reserved trash page beyond the scheduler's; the
        # split step drops such writes on the host and needs none
        self._trash_pages = 1 if self.ragged else 0
        # the split step's prefill budget in whole chunks (at least one)
        if self.chunked:
            self._chunks_per_step = max(
                1, (serve_cfg.prefill_token_budget
                    or serve_cfg.prefill_chunk) // serve_cfg.prefill_chunk)
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
            prefill_chunk=serve_cfg.prefill_chunk if self.chunked else 0,
            prefill_max_chunks=serve_cfg.prefill_max_chunks,
            prefix_cache=self.prefix_enabled,
            admit_window=serve_cfg.admit_window,
            max_deferrals=serve_cfg.max_deferrals,
            num_draft_tokens=self._k,
            unit_budget=unit_budget, track_allocs=self.tiered)
        self.cache = model.init_paged_cache(
            cfg, self.num_pages + self._trash_pages, ps, self.device,
            tiered=self.tiered, num_slots=serve_cfg.max_slots)
        if self.megakernel:
            # the kernel reads the (L, ...) stacks behind the per-layer
            # weights and pools; raises for params laid out otherwise
            model.megakernel_stacks(params, self.cache)
        self._step_model = (model.megakernel_step_paged if self.megakernel
                            else model.ragged_step_paged)
        # the ragged rows: up to prefill_max_chunks prompt chunks, or one
        # verify window (the split step and monolithic admission read
        # neither)
        self._width = max(1 + self._k, serve_cfg.prefill_chunk
                          * serve_cfg.prefill_max_chunks)
        self.steps = 0  # steps that decoded at least one token
        # attention kernel launches on the card over all steps / last step,
        # and those of one ragged or megakernel dispatch (the reference's
        # pallas_calls_per_step; measured at the first such dispatch on
        # the card, None on the CPU, where the plain versions run)
        self.kernel_launches = 0
        self.kernel_launches_last_step = 0
        self.launches_per_step = None
        # host wall time of each step's model dispatches, ending in a
        # device sync (sliding window); a split step's repack is outside
        self.step_seconds: deque = deque(maxlen=4096)
        # device dispatches by kind, as the reference counts them
        self.dispatch_counts = {"decode": 0, "verify": 0, "prefill": 0,
                                "ragged": 0, "write": 0, "repack": 0}
        self.prefill_dispatches = 0  # prefill-carrying model dispatches
        self._rr_clock = 0  # the split step's round-robin over prefills
        # how close the decisions came to going the other way: the
        # smallest lead of a greedy pick over its runner-up in bf16 ulps of
        # its logit; of a stochastic pick's perturbed score (logit + gumbel)
        # over the runner-up's; and |u - p(draft)| / p(draft) of a
        # stochastic acceptance test that counted
        self.min_top2_gap_ulps = float("inf")
        self.min_sample_lead = float("inf")
        self.min_accept_margin = float("inf")
        # speculative decoding stats, as the reference keeps them
        self.spec_steps = 0  # steps that verified drafts
        self.spec_seq_steps = 0  # (sequence, verify step) pairs
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.emitted_tokens = 0  # tokens recorded by verify steps
        self.prompt_tokens = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        # tiered pool state, on the host: one format id and last-write
        # tick per physical page (a trash page included), shared by every
        # layer like the page table, with a device mirror for the kernels
        self._tick = 0  # advances first in every step(); drives page ages
        self._mixed_fmts = None
        if self.tiered:
            tp = self.tier
            self._mixed_fmts = tuple(dict.fromkeys(
                (cfg.quant.fmt, tp.mid_fmt, tp.cold_fmt)))
            self._base_fmt_id = FORMAT_IDS[cfg.quant.fmt]
            self.page_fmts = np.full((self.num_pages + self._trash_pages,),
                                     self._base_fmt_id, np.int32)
            self._page_fmts_dev = torch.as_tensor(self.page_fmts,
                                                  device=self.device)
            self._fmts_dirty = False
            self._last_write = np.zeros(
                (self.num_pages + self._trash_pages,), np.int64)
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

    def _count_dispatch(self, kind: str) -> None:
        self.dispatch_counts[kind] += 1

    def _launches(self) -> int:
        return sum(k.launches for k in _ATTN_KERNELS)

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
        One dispatch repacks a uniform stack's (L, ...) pools in one call,
        another model's pools one call a layer."""
        ll = self.tier.repack_list_len
        bs = min(self.cfg.quant.block_size, self.cfg.head_dim)
        stack = self.cache.stack
        pools = [{k: stack[k] for k in model.POOL_KEYS}] \
            if stack is not None else self.cache
        for lo in range(0, len(pids), ll):
            group = pids[lo:lo + ll]
            ids = group + [group[-1]] * (ll - len(group))
            fmts = [int(self.page_fmts[p]) for p in ids]
            ids_t = torch.as_tensor(ids, dtype=torch.int32,
                                    device=self.device)
            fmts_t = torch.as_tensor(fmts, dtype=torch.int32,
                                     device=self.device)
            for pool in pools:
                mx_repack_pages(
                    pool["k_elems"], pool["k_scales"], pool["v_elems"],
                    pool["v_scales"], ids_t, fmts_t, len(group),
                    dst_fmt_name=dst_fmt, mixed_fmts=self._mixed_fmts,
                    block_size=bs)
            self.repack_dispatches += 1
            self._count_dispatch("repack")
            for pid in group:
                self._set_page_fmt(pid, dst_fmt)
            self.repacked_pages += len(group)
            self._repacked_this_step += len(group)

    def _protected_pages(self) -> set:
        """Pages the tiering pass must not touch this step: a prefilling
        sequence's pages from its resume point on, and every decode-ready
        sequence's live write window (1 + K rows under speculation)."""
        sched = self.scheduler
        ps = self.serve_cfg.page_size
        protected = set()
        for seq in sched.prefilling():
            protected.update(seq.pages[seq.prefill_pos // ps:])
        for seq in sched.decode_ready():
            lo = seq.pos // ps
            hi = min(len(seq.pages), (seq.pos + self._k) // ps + 1)
            protected.update(seq.pages[lo:hi])
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
                    # the state rows land in whatever slot it got now
                    kv_cache.restore_seq(
                        self.cache, snapshot,
                        self._ids([seq.pages[i] for i in owned_idx]),
                        slot=seq.slot)
                    self._count_dispatch("write")
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
            self.prompt_tokens += len(seq.req.prompt)
            # chunked admission only binds the slot and pages (the prompt
            # streams through the engine steps); monolithic prefills here
            if not self.chunked:
                self._admit_monolithic(seq)

    def _admit_monolithic(self, seq) -> None:
        """Prefill ``seq``'s prompt whole and install it into its pages:
        cold, one ``model.prefill``; over a prefix hit, a tail prefill
        against the hit's pages. A hit that ends mid-page extends the
        partial page in place, so a shared one is copied first (if no
        page is left for the copy, the tree's partial entry lets go of
        it) and the tail's rows land at its offset. Then the prompt
        registers in the prefix tree and its first token is sampled from
        the prefill's logits (stream index 0)."""
        sched = self.scheduler
        ps = self.serve_cfg.page_size
        prompt = seq.req.prompt
        cached = seq.cached_tokens
        dev = self.device
        if cached:
            n_full, valid = divmod(cached, ps)
            n_gather = n_full + (1 if valid else 0)
            tail = prompt[cached:]
            if valid and sched.pool.ref(seq.pages[n_full]) > 1:
                self._copy_on_write(seq, n_full)
            logits, pfcache = model.prefill_with_prefix(
                self.params, self.cfg_prefill, self.cache,
                torch.as_tensor(tail[None], device=dev).long(),
                self._ids(seq.pages[:n_gather]), cached,
                kv_cache.pages_for(len(tail), ps) * ps)
            self._count_dispatch("prefill")
            self.prefill_tokens += len(tail)
            layers = model.cache_layers(self.cfg_prefill, pfcache)
            ids = self._ids(seq.pages[n_full:])
            if valid:
                kv_cache.install_prefill_offset(self.cache, layers, ids, ps,
                                                valid, len(tail),
                                                slot=seq.slot)
            else:
                kv_cache.install_prefill(self.cache, layers, ids, ps,
                                         slot=seq.slot)
        else:
            logits, pfcache = model.prefill(
                self.params, self.cfg_prefill,
                torch.as_tensor(prompt[None], device=dev).long(),
                max_seq=kv_cache.pages_for(len(prompt), ps) * ps)
            self._count_dispatch("prefill")
            self.prefill_tokens += len(prompt)
            # pages for attention layers, the slot's rows for recurrent ones
            kv_cache.install_prefill(
                self.cache, model.cache_layers(self.cfg_prefill, pfcache),
                self._ids(seq.pages), ps, slot=seq.slot)
        self._count_dispatch("write")
        sched.register_prefix(seq)
        tok = int(self._sample_rows(logits[:, -1], [(0, seq)])[0])
        self._count_dispatch("prefill")
        self._record_first_token(seq.req.id)
        sched.record_token(seq, tok, eos_id=self.serve_cfg.eos_id)

    def _swap_out(self, victim) -> None:
        """Preempt ``victim``: snapshot + free only the pages it owns
        alone; shared pages keep their other references."""
        sched = self.scheduler
        owned_idx, owned_ids = sched.exclusive_pages(victim)
        snapshot = None
        if owned_ids:
            # its pages and its slot's state rows
            snapshot = kv_cache.extract_seq(self.cache, self._ids(owned_ids),
                                            slot=victim.slot)
            self._count_dispatch("write")
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
            self._count_dispatch("write")
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

    def _copy_on_write(self, seq, i: int) -> Optional[int]:
        """Give ``seq`` sole ownership of its shared page ``seq.pages[i]``
        before a write: a fresh page with the shared one's bytes, or, when
        none is left, the prefix tree's partial entry lets go of it
        (:meth:`_unpin_partial`). Returns the new page (None: written in
        place); raises when the pool cannot give either."""
        sched = self.scheduler
        pid = seq.pages[i]
        new = self._alloc_one(seq)
        if new is None:
            if self._unpin_partial(pid):
                return None
            raise RuntimeError("page pool exhausted for a lone sequence")
        kv_cache.copy_page(self.cache, pid, new)
        self._count_dispatch("write")
        sched.pool.free([pid])
        seq.pages[i] = new
        sched.cow_copies += 1
        return new

    def _unpin_partial(self, pid: int) -> bool:
        """When a page that must be written is shared and no page is left
        for its copy, and its only other holder is the prefix tree's
        partial entry, drop that entry so the writer owns the page: a pool
        sized to its sequences must not deadlock on the tree's own pin.
        True if the writer now holds ``pid`` alone."""
        prefix = self.scheduler.prefix
        return (prefix is not None and prefix.release_partial(pid)
                and self.scheduler.pool.ref(pid) == 1)

    def _ensure_pages(self) -> None:
        """Grow each decoding sequence's table for this step's write window
        (its token, and K drafts under speculation) and give it sole
        ownership of every page in the window (copy-on-write): shared
        pages are never written, so rejected drafts touch only pages the
        sequence owns alone."""
        sched = self.scheduler
        ps = self.serve_cfg.page_size
        span = 1 + self._k
        for seq in list(sched.decode_ready()):
            if sched.slots[seq.slot] is not seq:
                continue  # already preempted by an elder this pass
            while not sched.try_grow(seq, span):
                if not self._relieve_pressure(seq):
                    raise RuntimeError(
                        "page pool exhausted for a lone sequence")
            for wp in range(seq.pos // ps, (seq.pos + span - 1) // ps + 1):
                pid = seq.pages[wp]
                if sched.pool.ref(pid) == 1:
                    continue
                src_fmt = (int(self.page_fmts[pid])
                           if self.tiered else None)
                new = self._copy_on_write(seq, wp)
                if self.tiered and new is not None \
                        and src_fmt != self._base_fmt_id:
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
                self._mark_write(seq.pages[seq.pos // ps:
                                           (seq.pos + span - 1) // ps + 1])

    def _tier_args(self) -> dict:
        if not self.tiered:
            return {}
        return dict(page_fmts=self._sync_fmts(),
                    mixed_fmts=self._mixed_fmts)

    def _record_first_token(self, req_id: int) -> None:
        """One admission-latency sample: submit to first sampled token."""
        t0 = self._submit_time.pop(req_id, None)
        if t0 is not None:
            latency = time.perf_counter() - t0
            self.admission_latencies.append(latency)
            self.overload.observe_first_token(latency)

    def _record_step_tokens(self, logits: torch.Tensor, picks) -> None:
        """Keep the smallest top-2 lead of the greedy ``(seq, logits row)``
        picks."""
        if picks:
            gap = float(sampling.top2_gap_ulps(
                logits[[row for _, row in picks]]).min())
            self.min_top2_gap_ulps = min(self.min_top2_gap_ulps, gap)

    # -- sampling -----------------------------------------------------------

    def _req_sampling(self, req) -> SamplingParams:
        return req.sampling if req.sampling is not None \
            else self._default_sampling

    def _sampling_vectors(self, rows: int, picks) -> Optional[tuple]:
        """The reference's per-row sampling vectors (temperatures, top-p,
        top-k on the device; seeds, counters) for ``rows`` logits rows,
        ``picks`` being (row, seq) pairs; the other rows stay greedy. A
        row's counter is its request's next stream index,
        ``len(generated)``, so slot, batch and preemption never enter its
        key. Returns (vectors, the set of stochastic rows), or None when
        every pick is greedy: the step then takes the exact argmax, which
        is what the vectors would give."""
        arrs = sampling.slot_arrays(rows)
        hot = set()
        for row, seq in picks:
            sp = self._req_sampling(seq.req)
            arrs["temps"][row] = sp.temperature
            arrs["top_ps"][row] = sp.top_p
            arrs["top_ks"][row] = sp.top_k
            arrs["seeds"][row] = seq.req.seed
            arrs["counters"][row] = len(seq.req.generated)
            if sp.temperature > 0:
                hot.add(row)
        if not hot:
            return None
        # seeds and counters stay on the host, where the keys are made
        return tuple(torch.as_tensor(arrs[k], device=self.device)
                     for k in ("temps", "top_ps", "top_ks")) \
            + (arrs["seeds"], arrs["counters"]), hot

    def _sample_rows(self, logits: torch.Tensor, picks) -> np.ndarray:
        """One token per row of (N, V) ``logits`` (``sampling.sample``),
        on the host (this syncs); records the picks' margins."""
        got = self._sampling_vectors(logits.shape[0], picks)
        hot = set() if got is None else got[1]
        if got is None:
            toks = sampling.greedy(logits).cpu().numpy()
        else:
            toks, lead = sampling.sample(logits, *got[0], with_lead=True)
            toks, lead = toks.cpu().numpy(), lead.cpu().numpy()
            self.min_sample_lead = min([self.min_sample_lead]
                                       + [float(lead[row]) for row in hot])
        self._record_step_tokens(logits, [(seq, row) for row, seq in picks
                                          if row not in hot])
        return toks

    def _verify_rows(self, logits: torch.Tensor, drafts: np.ndarray,
                     picks) -> tuple:
        """Acceptance of each verify row: (N, 1 + K, V) ``logits``, (N, K)
        host ``drafts``; returns host (num_emitted (N,), emitted (N, 1 + K))
        of ``sampling.verify_rejection`` and records the margins of the
        decisions that counted. A greedy batch takes its argmax targets
        and ``spec_decode.greedy_accept``, which is what verify_rejection
        gives greedy rows."""
        n, t, v = logits.shape
        got = self._sampling_vectors(n, picks)
        hot = set() if got is None else got[1]
        if got is None:
            targets = sampling.greedy(logits.reshape(n * t, v)).reshape(
                n, t).cpu().numpy()
            n_emit = np.zeros((n,), np.int64)
            emitted = np.zeros((n, t), np.int64)
            for row, _ in picks:
                acc, em = spec_decode.greedy_accept(drafts[row],
                                                    targets[row])
                n_emit[row] = acc + 1
                emitted[row, :acc + 1] = em
        else:
            n_emit, emitted, (gap, lead) = sampling.verify_rejection(
                logits, torch.as_tensor(drafts, device=self.device), *got[0],
                margins=True)
            n_emit, emitted = n_emit.cpu().numpy(), emitted.cpu().numpy()
            gap, lead = gap.cpu().numpy(), lead.cpu().numpy()
            for row in hot:
                # the tests up to the first rejection, and the last draw
                self.min_accept_margin = min(
                    self.min_accept_margin,
                    float(gap[row, :min(int(n_emit[row]), t - 1)].min()))
                self.min_sample_lead = min(self.min_sample_lead,
                                           float(lead[row]))
        self._record_step_tokens(
            logits.reshape(n * t, v),
            [(seq, row * t + j) for row, seq in picks if row not in hot
             for j in range(int(n_emit[row]))])
        return n_emit, emitted

    def _draft(self, seq, k: int) -> np.ndarray:
        """The drafter's ``k`` proposals after ``seq``'s history."""
        history = np.concatenate([seq.req.prompt,
                                  np.asarray(seq.req.generated, np.int32)])
        drafts = np.asarray(self.drafter.propose(history, k), np.int32)
        if drafts.shape != (k,):
            raise ValueError(f"drafter returned shape {drafts.shape}, "
                             f"wanted ({k},)")
        return drafts

    def _emit(self, seq, tokens) -> None:
        """Record a verify row's emitted tokens: each validates one more
        written row (advance) before it is recorded; stopping early (EOS,
        max_new) leaves the rest past the position, rolled back."""
        sched = self.scheduler
        self.spec_seq_steps += 1
        self.drafted_tokens += self._k
        self.accepted_tokens += len(tokens) - 1
        for tok in tokens:
            sched.advance(seq)
            self.emitted_tokens += 1
            if not sched.record_token(seq, int(tok),
                                      eos_id=self.serve_cfg.eos_id):
                break

    def _ragged_step(self) -> None:
        sched = self.scheduler
        k = self._k
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
         decode, prefill) = sched.assemble_ragged(self._width,
                                                  extra_tokens=k)
        if not decode and not prefill:
            return
        for seq in decode if k else ():
            tokens[seq.slot, 1:1 + k] = self._draft(seq, k)
        dev = self.device
        tier_args = self._tier_args()
        launches0 = self._launches()
        t0 = time.perf_counter()
        logits = self._step_model(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(row_start, device=dev),
            torch.as_tensor(seq_lens, device=dev),
            torch.as_tensor(logit_idx, device=dev),
            num_logits=1 + k if k else None, **tier_args)
        # decode rows sample row 0 without speculation and verify their
        # 1 + K rows with it; a prompt-final chunk samples its first token
        # (stream index 0) from its row 0
        firsts = [(seq.slot, seq) for seq, _, _, final in prefill if final]
        verify = [(seq.slot, seq) for seq in decode] if k else []
        if not k:
            firsts = [(seq.slot, seq) for seq in decode] + firsts
        toks = (self._sample_rows(logits[:, 0] if k else logits, firsts)
                if firsts else None)  # syncs
        if verify:
            n_emit, emitted = self._verify_rows(logits, tokens[:, 1:1 + k],
                                                verify)  # syncs
        if not firsts and not verify and dev.type == "cuda":
            # only non-final chunks ran: no token read synced the step
            torch.cuda.synchronize(dev)
        self.step_seconds.append(time.perf_counter() - t0)
        if self.launches_per_step is None and dev.type == "cuda":
            self.launches_per_step = self._launches() - launches0
            log.info("step audit: %d kernel launch(es) per engine step (%s)",
                     self.launches_per_step,
                     "layer-fused megakernel" if self.megakernel
                     else "per-layer ragged step")
        self._count_dispatch("ragged")
        if decode:
            self.steps += 1
            self.spec_steps += bool(k)
        if prefill:
            self.prefill_chunks += len(prefill)
            self.prefill_tokens += int(sum(t[2] for t in prefill))
            self.prefill_dispatches += 1
        eos = self.serve_cfg.eos_id
        for seq in decode:
            if k:
                self._emit(seq, emitted[seq.slot, :int(n_emit[seq.slot])])
            else:
                sched.advance(seq)
                sched.record_token(seq, int(toks[seq.slot]), eos_id=eos)
        for seq, st, real, final in prefill:
            seq.pos = st + real
            seq.prefill_pos = None if final else st + real
            if final:
                sched.register_prefix(seq)
                self._record_first_token(seq.req.id)
                sched.record_token(seq, int(toks[seq.slot]), eos_id=eos)

    # -- the split step -----------------------------------------------------

    def _run_prefill_chunks(self) -> Optional[float]:
        """Advance chunked prefills by up to the per-step budget of whole
        chunks, round-robin across prefilling sequences with the rotation
        carried across steps (``_rr_clock``), each round one batched
        dispatch. Returns the host seconds of the dispatches, ending in a
        device sync (None: no sequence was prefilling)."""
        sched = self.scheduler
        budget = self._chunks_per_step
        t0 = time.perf_counter()
        ran = False
        while budget > 0:
            pref = sched.prefilling()
            if not pref:
                break
            start = self._rr_clock % len(pref)
            take = min(budget, len(pref))
            self._rr_clock += take
            self._prefill_chunk_batch(
                [pref[(start + i) % len(pref)] for i in range(take)])
            budget -= take
            ran = True
        if not ran:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _prefill_chunk_batch(self, seqs) -> None:
        """One fixed-size chunk for each of ``seqs`` in one
        ``model.prefill_chunk_paged`` dispatch (B rows); a sequence on its
        final chunk samples its first token from its own logits row."""
        sched = self.scheduler
        c = self.serve_cfg.prefill_chunk
        bsz = len(seqs)
        tokens = np.zeros((bsz, c), np.int32)
        rows = np.full((bsz, sched.pages_per_slot), -1, np.int32)
        starts = np.zeros((bsz,), np.int32)
        reals = np.zeros((bsz,), np.int32)
        for i, seq in enumerate(seqs):
            prompt = seq.req.prompt
            st = seq.prefill_pos
            real = min(c, len(prompt) - st)
            tokens[i, :real] = prompt[st:st + real]
            rows[i, : len(seq.pages)] = seq.pages
            starts[i], reals[i] = st, real
        if self.tiered:
            self._drain_allocs()
            ps = self.serve_cfg.page_size
            for i, seq in enumerate(seqs):
                self._mark_write(seq.pages[starts[i] // ps:
                                           (starts[i] + reals[i] - 1)
                                           // ps + 1])
        dev = self.device
        logits = model.prefill_chunk_paged(
            self.params, self.cfg_decode, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(starts, device=dev),
            torch.as_tensor(reals, device=dev),
            torch.as_tensor(reals - 1, device=dev), **self._tier_args())
        self._count_dispatch("prefill")
        self.prefill_tokens += int(reals.sum())
        self.prefill_chunks += bsz
        self.prefill_dispatches += 1
        final = [int(starts[i]) + int(reals[i]) >= len(seq.req.prompt)
                 for i, seq in enumerate(seqs)]
        toks = None
        if any(final):
            # the reference samples every row of the batch in one dispatch
            # (stream index 0 of each request)
            toks = self._sample_rows(logits[:, -1], [
                (i, seq) for i, seq in enumerate(seqs) if final[i]])
            self._count_dispatch("prefill")
        for i, seq in enumerate(seqs):
            seq.pos = int(starts[i]) + int(reals[i])
            seq.prefill_pos = int(starts[i]) + c
            if final[i]:
                seq.prefill_pos = None
                sched.register_prefix(seq)
                self._record_first_token(seq.req.id)
                sched.record_token(seq, int(toks[i]),
                                   eos_id=self.serve_cfg.eos_id)

    def _decode_step(self) -> float:
        """One ``model.decode_step_paged`` over the decode-ready slots.
        Returns its host seconds (the token fetch syncs)."""
        sched = self.scheduler
        self._ensure_pages()
        tokens, pos, page_rows, act = sched.assemble()
        dev = self.device
        t0 = time.perf_counter()
        logits = model.decode_step_paged(
            self.params, self.cfg_decode, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(pos, device=dev), **self._tier_args())
        toks = self._sample_rows(logits[:, -1], [(seq.slot, seq)
                                                 for seq in act])  # syncs
        seconds = time.perf_counter() - t0
        self._count_dispatch("decode")
        self.steps += 1
        for seq in act:
            sched.advance(seq)
            sched.record_token(seq, int(toks[seq.slot]),
                               eos_id=self.serve_cfg.eos_id)
        return seconds

    def _spec_step(self) -> float:
        """One draft + verify step over the decode-ready slots: each feeds
        its pending token and K drafts through ``model.verify_step_paged``
        (Tq = 1 + K, every token's K/V written into pages the sequence
        owns alone), and ``sampling.verify_rejection`` picks what to emit.
        Rejected drafts roll back by position. Returns its host seconds."""
        sched = self.scheduler
        k = self._k
        self._ensure_pages()
        tokens, pos, page_rows, act = sched.assemble(extra_tokens=k)
        for seq in act:
            tokens[seq.slot, 1:] = self._draft(seq, k)
        dev = self.device
        t0 = time.perf_counter()
        logits = model.verify_step_paged(
            self.params, self.cfg_decode, self.cache,
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(pos, device=dev), **self._tier_args())
        n_emit, emitted = self._verify_rows(
            logits, tokens[:, 1:], [(seq.slot, seq) for seq in act])
        seconds = time.perf_counter() - t0
        self._count_dispatch("verify")
        self.steps += 1
        self.spec_steps += 1
        for seq in act:
            self._emit(seq, emitted[seq.slot, :int(n_emit[seq.slot])])
        return seconds

    def _split_step(self) -> None:
        """The reference's split order: prefill chunks under the budget
        (a prompt's final chunk samples its first token, and the sequence
        decodes in this same step), the tiering pass, then one decode (or
        verify) dispatch if any sequence is ready."""
        seconds = self._run_prefill_chunks() if self.chunked else None
        self._run_repack()
        if self.scheduler.decode_ready():
            seconds = (seconds or 0.0) + (
                self._spec_step() if self.spec_enabled
                else self._decode_step())
        if seconds is not None:
            self.step_seconds.append(seconds)

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit what fits, then one engine step over every active
        sequence: the tiering pass and one ragged dispatch, or the split
        step's dispatches (see :meth:`_split_step`), in the reference's
        order. Returns True if any work remains afterwards."""
        launches0 = self._launches()
        try:
            return self._step_inner()
        finally:
            self.kernel_launches_last_step = self._launches() - launches0
            self.kernel_launches += self.kernel_launches_last_step

    def _step_inner(self) -> bool:
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
        if self.ragged:
            self._run_repack()
            self._ragged_step()
        else:
            self._split_step()
        return sched.has_work

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run one full-width step with every row inactive, so that the
        dense products' first launches and the allocator's growth happen
        here rather than inside a timed run. Ragged: all -1 tables, each
        layer's write lands on the trash page. Split: one decode
        dispatch, whose writes all drop (the prefill kernel writes at
        least one row, so it is not warmed). No live page, no page format
        or age and no engine counter changes; the kernel wrappers' launch
        counts do. Recurrent state rows, which the decode steps in every
        slot, are put back afterwards."""
        states = [{k: t.clone() for k, t in entry.items()}
                  for entry in self.cache if not kv_cache.is_pool(entry)]
        self._warmup_dispatch()
        for entry, saved in zip((e for e in self.cache
                                 if not kv_cache.is_pool(e)), states):
            for k, t in entry.items():
                t.copy_(saved[k])

    def _warmup_dispatch(self) -> None:
        rows = self.serve_cfg.max_slots
        dev = self.device
        zeros = torch.zeros((rows,), dtype=torch.int32, device=dev)
        table = torch.full((rows, self.scheduler.pages_per_slot), -1,
                           dtype=torch.int32, device=dev)
        if self.ragged:
            self._step_model(
                self.params, self.cfg, self.cache,
                torch.zeros((rows, self._width), dtype=torch.long,
                            device=dev), table, zeros, zeros + 1, zeros,
                num_logits=1 + self._k if self._k else None,
                **self._tier_args())
        else:
            model.decode_step_paged(
                self.params, self.cfg_decode, self.cache,
                torch.zeros((rows, 1), dtype=torch.long, device=dev), table,
                zeros, **self._tier_args())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               sampling_params: Optional[SamplingParams] = None) -> int:
        """Queue one request; returns its id. Use with :meth:`run`.
        ``sampling_params`` overrides the engine's default temperature,
        top-p, top-k and seed for this request (None: the defaults).
        Raises :class:`~.overload.ShedError` when overload control sheds
        it, before it costs a slot, pages or prefill."""
        self.overload.admit(len(self.scheduler.queue))
        sp = (sampling_params.validate() if sampling_params is not None
              else self._default_sampling)
        seed = sampling.resolve_seed(sp, self.serve_cfg.seed,
                                     self.scheduler._next_id)
        rid = self.scheduler.submit(prompt, max_new_tokens, sampling=sp,
                                    seed=seed)
        self._submit_time[rid] = time.perf_counter()
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abandon a request between steps, wherever it is (queued,
        mid-prefill, decoding, mid-verify, swapped out), freeing its slot
        and page references (``Scheduler.cancel``). False: it had already
        finished, or never existed."""
        found = self.scheduler.cancel(request_id)
        if found:
            self._submit_time.pop(request_id, None)
            if self.tiered:
                self._swap_fmts.pop(request_id, None)
        return found

    def save_prefix_cache(self, path) -> int:
        """Write the prefix tree and the exact bytes of every page it holds
        to ``path`` (``np.savez``, the reference's layout): ``structure``
        (``PrefixCache.export_state`` as JSON bytes), ``page_ids``, and for
        each leaf of ``model.reference_cache_leaves`` its bytes, dtype
        name and shape; a tiered engine adds each page's format id
        (``page_fmts``). Returns the number of pages saved."""
        prefix = self.scheduler.prefix
        if prefix is None:
            raise RuntimeError("engine has no prefix cache to save")
        state = prefix.export_state()
        pids = sorted({node["page"] for node in state["nodes"]}
                      | {ent["page"] for ent in state["partials"]})
        payload = {
            "structure": np.frombuffer(json.dumps(state).encode(), np.uint8),
            "page_ids": np.asarray(pids, np.int64),
        }
        if self.tiered:
            payload["page_fmts"] = np.asarray(
                [int(self.page_fmts[p]) for p in pids], np.int32)
        if pids:
            layout = model.reference_cache_leaves(self.cfg, self.cache)
            leaves = kv_cache.extract_leaves(self.cache, layout,
                                             self._ids(pids))
            geometry = kv_cache.snapshot_geometry(self.cache, layout,
                                                  len(pids))
            for i, (data, (name, shape)) in enumerate(zip(leaves, geometry)):
                payload[f"leaf_{i}_bytes"] = data.cpu().numpy().reshape(-1)
                payload[f"leaf_{i}_dtype"] = np.asarray(name)
                payload[f"leaf_{i}_shape"] = np.asarray(shape, np.int64)
        np.savez(path, **payload)
        return len(pids)

    def load_prefix_cache(self, path) -> int:
        """Warm-start an empty prefix cache from :meth:`save_prefix_cache`
        output (this package's or the reference's): fresh pages, the saved
        bytes restored into them verbatim, the tree rebuilt over the new
        ids and, tiered, each page's saved format re-applied. A snapshot
        of another model or page geometry raises ``ValueError`` before any
        page is taken. Returns the number of tree nodes imported."""
        prefix = self.scheduler.prefix
        if prefix is None:
            raise RuntimeError("engine has no prefix cache to load into")
        with np.load(path) as data:
            state = json.loads(bytes(data["structure"]).decode())
            old_ids = [int(x) for x in data["page_ids"]]
            leaves, fmts = [], []
            if old_ids:
                layout = model.reference_cache_leaves(self.cfg, self.cache)
                for i, (name, shape) in enumerate(kv_cache.snapshot_geometry(
                        self.cache, layout, len(old_ids))):
                    got_name = str(data[f"leaf_{i}_dtype"])
                    got_shape = tuple(int(n) for n in data[f"leaf_{i}_shape"])
                    if got_name != name or got_shape != shape:
                        raise ValueError(
                            f"prefix snapshot leaf {i} is {got_name}"
                            f"{got_shape}, this engine expects {name}{shape}"
                            " — saved under a different model or page "
                            "config")
                    # as bytes: the last axis widens by the element size
                    leaves.append(torch.from_numpy(np.array(
                        data[f"leaf_{i}_bytes"])).reshape(*shape[:-1], -1))
                if self.tiered:
                    fmts = [int(f) for f in data["page_fmts"]]
        prefix.check_state(state)
        missing = ({n["page"] for n in state["nodes"]}
                   | {e["page"] for e in state["partials"]}) - set(old_ids)
        if missing:
            raise ValueError(f"prefix snapshot names pages {sorted(missing)}"
                             " that it does not carry")
        new_ids = []
        if old_ids:
            new_ids = self.scheduler.alloc_with_evict(len(old_ids))
            if new_ids is None:
                raise RuntimeError(
                    f"page pool cannot hold {len(old_ids)} imported "
                    "prefix pages")
            kv_cache.restore_leaves(
                self.cache, layout, [b.to(self.device) for b in leaves],
                self._ids(new_ids))
        count = prefix.import_state(state, dict(zip(old_ids, new_ids)))
        if self.tiered:
            # alloc reset the fresh pages to the base format: put back the
            # formats their bytes were saved in
            self._drain_allocs()
            for pid, fid in zip(new_ids, fmts):
                if fid != self._base_fmt_id:
                    self._set_page_fmt(pid, FORMAT_BY_ID[fid])
        return count

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

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 key=None) -> np.ndarray:
        """The batch API, shaped as ``FixedSlotEngine.generate``: (B, S0)
        prompts -> (B, S0 + max_new_tokens) int32, a row that stops early
        at EOS right-padded with ``eos_id`` (0 without one). ``key`` is
        the reference's argument; each request samples from its own seed,
        so nothing reads it, there or here."""
        prompts = np.asarray(prompts, np.int32)
        b, s0 = prompts.shape
        ids = [self.submit(prompts[i], max_new_tokens) for i in range(b)]
        results = self.run()
        pad = self.serve_cfg.eos_id if self.serve_cfg.eos_id is not None \
            else 0
        out = np.full((b, s0 + max_new_tokens), pad, np.int32)
        for row, rid in enumerate(ids):
            out[row, :len(results[rid])] = results[rid]
        return out

    def cache_stats(self) -> Dict[str, float]:
        """Allocation, preemption, prefix-sharing and dispatch stats."""
        page_bytes = kv_cache.pool_page_nbytes(
            self.cache, self.num_pages + self._trash_pages)
        sched = self.scheduler
        stats = {
            "allocated_bytes": kv_cache.cache_nbytes(self.cache),
            "page_bytes": page_bytes,
            "state_bytes": kv_cache.state_nbytes(self.cache),
            "peak_pages": sched.peak_pages,
            "resident_tokens_at_peak": sched.resident_at_peak,
            "preemptions": sched.preemptions,
            "peak_paged_bytes": page_bytes * sched.peak_pages,
            "skipped_admissions": sched.skipped_admissions,
            "deferred_admissions": sched.deferred_admissions,
            "deferral_fallbacks": sched.deferral_fallbacks,
            "cancellations": sched.cancellations,
            "shed_count": self.overload.shed_count,
            "cow_copies": sched.cow_copies,
            "prompt_tokens": self.prompt_tokens,
            "prefill_tokens_computed": self.prefill_tokens,
            "prefix_hit_rate": (
                1.0 - self.prefill_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0),
            "prefill_chunks": self.prefill_chunks,
            "prefill_dispatches": self.prefill_dispatches,
            # prompt rows retired per prefill-carrying dispatch (above the
            # chunk size: multi-chunk bites on undersubscribed steps)
            "prefill_rows_per_step": (
                self.prefill_tokens / self.prefill_dispatches
                if self.prefill_dispatches else 0.0),
            "step_mode": ("megakernel" if self.megakernel
                          else "ragged" if self.ragged else "split"),
            "megakernel": self.megakernel,
            "megakernel_fallback_reason": self._megakernel_fallback_reason,
            "ragged_steps": self.dispatch_counts["ragged"],
            "decode_steps": self.steps,
            "kernel_launches": self.kernel_launches,
            "launches_per_step": self.launches_per_step,
            "min_top2_gap_ulps": self.min_top2_gap_ulps,
            "min_sample_lead": self.min_sample_lead,
            "min_accept_margin": self.min_accept_margin,
        }
        for kind, n in self.dispatch_counts.items():
            stats[f"dispatches_{kind}"] = n
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
        if self.admission_latencies:
            lat = np.sort(np.asarray(self.admission_latencies))
            stats["admission_latency_p50"] = float(
                lat[int(0.50 * (len(lat) - 1))])
            stats["admission_latency_p95"] = float(
                lat[int(round(0.95 * (len(lat) - 1)))])
            stats["admission_latency_mean"] = float(lat.mean())
        if self.spec_enabled:
            stats.update({
                "spec_steps": self.spec_steps,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "emitted_tokens": self.emitted_tokens,
                # tokens a sequence emits per verify step it takes part in
                # (1: no better than decode, K + 1: every draft accepted)
                "accepted_per_step": (
                    self.emitted_tokens / self.spec_seq_steps
                    if self.spec_seq_steps else 0.0),
                "draft_acceptance_rate": (
                    self.accepted_tokens / self.drafted_tokens
                    if self.drafted_tokens else 0.0),
            })
        if sched.prefix is not None:
            stats.update(sched.prefix.stats())
        return stats


def _param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _param_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _param_leaves(v)
    else:
        yield tree


# the default engine: continuous batching over the paged MX cache
ServeEngine = ContinuousBatchingEngine


def make_serve_step(cfg: ModelConfig):
    """The (params, cache, tokens, pos) -> (logits, cache) one-token
    decode step over a contiguous cache (``model.decode_step``; the cache
    updates in place and is returned as the reference returns it)."""

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cfg, cache, tokens, pos)

    return serve_step
