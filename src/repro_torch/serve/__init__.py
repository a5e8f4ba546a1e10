"""Serving: MX weights + paged MX KV cache, continuous batching with the
ragged step, radix-tree prefix sharing and swap preemption."""
from .engine import ContinuousBatchingEngine, ServeConfig, ServeEngine
from .kv_cache import PagePool, pages_for, pages_spanned
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "PagePool", "PrefixCache", "Request",
           "SamplingParams", "Scheduler", "ServeConfig", "ServeEngine",
           "pages_for", "pages_spanned"]
