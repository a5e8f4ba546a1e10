"""Serving: MX weights + paged MX KV cache, continuous batching with the
ragged step or monolithic prefill, the fixed-slot golden engine,
radix-tree prefix sharing, swap preemption, the tiered
mixed-format cache, stochastic sampling on counter-based streams,
speculative decoding with lossless verification, SLO-aware overload
control, and an asyncio HTTP/SSE front end."""
from .engine import (ContinuousBatchingEngine, FixedSlotEngine, ServeConfig,
                     ServeEngine, TierPolicy, make_serve_step)
from .kv_cache import PagePool, pages_for, pages_spanned
from .overload import OverloadConfig, OverloadController, ShedError
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import Request, Scheduler
from .server import AsyncServeEngine, DrainingError, ServeHTTPServer
from .spec_decode import (Drafter, NgramDrafter, ScriptedDrafter,
                          greedy_accept)

__all__ = ["AsyncServeEngine", "ContinuousBatchingEngine", "Drafter",
           "DrainingError", "FixedSlotEngine", "NgramDrafter",
           "OverloadConfig", "OverloadController", "PagePool", "PrefixCache",
           "Request", "SamplingParams", "Scheduler", "ScriptedDrafter",
           "ServeConfig", "ServeEngine", "ServeHTTPServer", "ShedError",
           "TierPolicy", "greedy_accept", "make_serve_step", "pages_for",
           "pages_spanned"]
