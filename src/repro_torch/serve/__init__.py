"""Serving: MX weights + paged MX KV cache, continuous batching with the
ragged step, radix-tree prefix sharing, swap preemption, the tiered
mixed-format cache, stochastic sampling on counter-based streams,
speculative decoding with lossless verification, SLO-aware overload
control, and an asyncio HTTP/SSE front end."""
from .engine import (ContinuousBatchingEngine, ServeConfig, ServeEngine,
                     TierPolicy)
from .kv_cache import PagePool, pages_for, pages_spanned
from .overload import OverloadConfig, OverloadController, ShedError
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import Request, Scheduler
from .server import AsyncServeEngine, DrainingError, ServeHTTPServer
from .spec_decode import (Drafter, NgramDrafter, ScriptedDrafter,
                          greedy_accept)

__all__ = ["AsyncServeEngine", "ContinuousBatchingEngine", "Drafter",
           "DrainingError", "NgramDrafter", "OverloadConfig",
           "OverloadController", "PagePool", "PrefixCache", "Request",
           "SamplingParams", "Scheduler", "ScriptedDrafter", "ServeConfig",
           "ServeEngine", "ServeHTTPServer", "ShedError", "TierPolicy",
           "greedy_accept", "pages_for", "pages_spanned"]
