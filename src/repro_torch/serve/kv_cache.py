"""Paged MX KV cache: host-side page pool + device-side page surgery
(port of ``repro.serve.kv_cache``).

``PagePool`` is pure host bookkeeping (free list, refcounts, peak usage);
the device cache is a list of per-layer page pools (``model.
init_paged_cache``). The ragged engine allocates ``num_pages + 1``
physical pages and never hands out the last one: the ragged kernel
routes inactive rows' writes to it (the trash page).

The device functions update the pools in place; the reference returns a
new cache pytree and its engine donates the old one.
"""
from __future__ import annotations

from typing import List

import torch


def pages_for(num_tokens: int, page_size: int) -> int:
    """Number of pages needed to hold ``num_tokens`` cache rows."""
    return -(-num_tokens // page_size)


def pages_spanned(pos0: int, num_tokens: int, page_size: int) -> int:
    """Page-table length a write of ``num_tokens`` rows at ``pos0..`` needs
    (its last page index + 1)."""
    if num_tokens <= 0:
        raise ValueError("write window must cover at least one token")
    return (pos0 + num_tokens - 1) // page_size + 1


class PagePool:
    """Ref-counted free-list allocator over a fixed set of physical page ids.

    A page can back many sequences' page tables (prefix sharing) plus the
    prefix radix tree: ``alloc`` hands out pages with one reference,
    every further holder calls :meth:`retain`, every holder releases with
    :meth:`free`, and the page returns to the free list when its last
    reference drops. Writers must hold the only reference (copy-on-write
    is the engine's job; :meth:`ref` tells it).
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._free_set = set(self._free)  # O(1) double-free detection
        self._ref = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def ref(self, pid: int) -> int:
        """Current reference count of ``pid`` (0 = on the free list)."""
        if not 0 <= pid < self.num_pages:
            raise ValueError(f"unknown page {pid}")
        return self._ref[pid]

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int):
        """Pop ``n`` page ids (refcount 1), or None (no change)."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if not self.can_alloc(n):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(ids)
        for pid in ids:
            self._ref[pid] = 1
        return ids

    def retain(self, ids) -> None:
        """Add one reference to each allocated page in ``ids``."""
        for pid in ids:
            if not 0 <= pid < self.num_pages:
                raise ValueError(f"retain of unknown page {pid}")
            if self._ref[pid] == 0:
                raise ValueError(f"retain of free page {pid}")
            self._ref[pid] += 1

    def free(self, ids) -> None:
        """Drop one reference per page; the last reference frees it."""
        for pid in ids:
            if not 0 <= pid < self.num_pages:
                raise ValueError(f"free of unknown page {pid}")
            if pid in self._free_set or self._ref[pid] == 0:
                raise ValueError(f"double free of page {pid}")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)
                self._free_set.add(pid)


# ---------------------------------------------------------------------------
# device-side page surgery (every layer's pool shares one page table)
# ---------------------------------------------------------------------------


def _leaves(pool: dict):
    """(key, uint8 view) of every leaf: fp8 and E8M0 leaves are one byte
    per element, and byte views take every indexing op on every device."""
    return [(key, leaf.view(torch.uint8)) for key, leaf in pool.items()]


def copy_page(cache: list, src: int, dst: int) -> None:
    """Copy physical page ``src`` -> ``dst`` in every layer's pool (the
    device half of copy-on-write)."""
    for pool in cache:
        for _, leaf in _leaves(pool):
            leaf[dst] = leaf[src]


def extract_seq(cache: list, page_ids: torch.Tensor) -> list:
    """Snapshot pages ``page_ids`` of every pool (swap-style preemption:
    restoring the exact bytes keeps generation bit-identical)."""
    return [{key: leaf.index_select(0, page_ids)
             for key, leaf in _leaves(pool)} for pool in cache]


def merge_snapshots(a, b: list) -> list:
    """Concatenate two :func:`extract_seq` snapshots along the page axis
    (``a`` may be None: a swap that owned no page exclusively)."""
    if a is None:
        return b
    return [{key: torch.cat([sa[key], sb[key]]) for key in sa}
            for sa, sb in zip(a, b)]


def restore_seq(cache: list, snapshot: list, page_ids: torch.Tensor) -> None:
    """Inverse of :func:`extract_seq` onto freshly allocated pages."""
    for pool, snap in zip(cache, snapshot):
        for key, leaf in _leaves(pool):
            leaf[page_ids] = snap[key]


def cache_nbytes(cache: list) -> int:
    """Total bytes of every pool leaf."""
    return sum(leaf.numel() * leaf.element_size()
               for pool in cache for leaf in pool.values())


def pool_page_nbytes(cache: list, num_pages: int) -> int:
    """Bytes one page costs across all layers."""
    total = cache_nbytes(cache)
    if total % num_pages:
        raise ValueError("pool bytes not divisible by page count")
    return total // num_pages
