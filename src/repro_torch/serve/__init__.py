"""Serving: MX weights + paged MX KV cache, continuous batching with the
ragged step, radix-tree prefix sharing, swap preemption, the tiered
mixed-format cache, stochastic sampling on counter-based streams and
speculative decoding with lossless verification."""
from .engine import (ContinuousBatchingEngine, ServeConfig, ServeEngine,
                     TierPolicy)
from .kv_cache import PagePool, pages_for, pages_spanned
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import Request, Scheduler
from .spec_decode import (Drafter, NgramDrafter, ScriptedDrafter,
                          greedy_accept)

__all__ = ["ContinuousBatchingEngine", "Drafter", "NgramDrafter", "PagePool",
           "PrefixCache", "Request", "SamplingParams", "Scheduler",
           "ScriptedDrafter", "ServeConfig", "ServeEngine", "TierPolicy",
           "greedy_accept", "pages_for", "pages_spanned"]
