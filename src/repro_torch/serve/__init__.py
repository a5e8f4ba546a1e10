"""Serving: MX weights + paged MX KV cache, continuous batching with the
ragged step, radix-tree prefix sharing, swap preemption and the tiered
mixed-format cache."""
from .engine import (ContinuousBatchingEngine, ServeConfig, ServeEngine,
                     TierPolicy)
from .kv_cache import PagePool, pages_for, pages_spanned
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "PagePool", "PrefixCache", "Request",
           "SamplingParams", "Scheduler", "ServeConfig", "ServeEngine",
           "TierPolicy", "pages_for", "pages_spanned"]
