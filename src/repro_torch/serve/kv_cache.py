"""Paged MX KV cache: host-side page pool + device-side page surgery
(port of ``repro.serve.kv_cache``).

``PagePool`` is pure host bookkeeping (free list, refcounts, peak usage,
and the tiered pool's quarter-page unit budget); the device cache is a
list of per-layer page pools (``model.init_paged_cache``). The ragged
engine allocates ``num_pages + 1`` physical pages and never hands out
the last one: the ragged kernel routes inactive rows' writes to it (the
trash page). A tiered page's element format lives in the engine's
per-page format ids, not in its bytes, so the page surgery below copies
bytes only and the engine carries the ids beside them.

The device cache interleaves two kinds of per-layer entries, told apart
by their keys as in the reference: page pools (``{"k", "v"}`` wide or
``{"k_elems", "k_scales", "v_elems", "v_scales"}`` MX, leaves (NP, PS,
KVH, .)) and a recurrent mixer's state rows (``{"h", "conv"}``, leaves
with the decode slot first). A request's prefill installs its pages and
its state row; a swap snapshot carries both, the state row keyed by the
slot it leaves and restored into the slot it gets.

The device functions update the pools in place; the reference returns a
new cache pytree and its engine donates the old one.
"""
from __future__ import annotations

from typing import List, Optional

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


#: Unit cost of a full-width page, in quarter-page units. Tiered pools
#: keep every page in full-width uint8 rows (a narrower format fills a row
#: prefix), but the budget meters what the page's format needs: fp8 4/4,
#: fp6 3/4, fp4 2/4 of a page, so repacking down the ladder frees budget.
PAGE_UNITS_FULL = 4

#: Quarter-page unit cost per element format bit width.
UNITS_BY_BITS = {8: 4, 6: 3, 4: 2}


class PagePool:
    """Ref-counted free-list allocator over a fixed set of physical page ids.

    A page can back many sequences' page tables (prefix sharing) plus the
    prefix radix tree: ``alloc`` hands out pages with one reference,
    every further holder calls :meth:`retain`, every holder releases with
    :meth:`free`, and the page returns to the free list when its last
    reference drops. Writers must hold the only reference (copy-on-write
    is the engine's job; :meth:`ref` tells it).

    With ``unit_budget`` (quarter-page units, :data:`PAGE_UNITS_FULL`)
    every fresh page costs the full 4 units, the tiering engine credits
    units back through :meth:`set_cost` when it repacks a page narrower,
    and :meth:`can_alloc`/:meth:`alloc` admit only while both pages and
    units remain. ``track_allocs`` logs every allocated id in
    ``alloc_log`` until the engine drains it (a recycled page must start
    over in the base format).
    """

    def __init__(self, num_pages: int, unit_budget: Optional[int] = None,
                 track_allocs: bool = False):
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        if unit_budget is not None and unit_budget <= 0:
            raise ValueError("unit_budget must be positive")
        self.num_pages = num_pages
        self.unit_budget = unit_budget
        self.track_allocs = track_allocs
        self.alloc_log: List[int] = []
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._free_set = set(self._free)  # O(1) double-free detection
        self._ref = [0] * num_pages
        self._cost = [PAGE_UNITS_FULL] * num_pages
        self.units_in_use = 0
        self.peak_in_use = 0
        self.peak_units = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def units_free(self) -> Optional[int]:
        """Remaining quarter-page units (None when not metering)."""
        if self.unit_budget is None:
            return None
        return self.unit_budget - self.units_in_use

    def _check(self, pid: int, what: str = "unknown page") -> None:
        if not 0 <= pid < self.num_pages:
            raise ValueError(f"{what} {pid}")

    def ref(self, pid: int) -> int:
        """Current reference count of ``pid`` (0 = on the free list)."""
        self._check(pid)
        return self._ref[pid]

    def cost(self, pid: int) -> int:
        """Current unit cost of allocated page ``pid``."""
        self._check(pid)
        return self._cost[pid]

    def set_cost(self, pid: int, units: int) -> None:
        """Re-meter an allocated page after a format change (repack);
        the cost belongs to the physical page, shared by its holders."""
        self._check(pid)
        if self._ref[pid] == 0:
            raise ValueError(f"set_cost of free page {pid}")
        if not 1 <= units <= PAGE_UNITS_FULL:
            raise ValueError(f"bad page cost {units}")
        self.units_in_use += units - self._cost[pid]
        self._cost[pid] = units
        self.peak_units = max(self.peak_units, self.units_in_use)

    def can_alloc(self, n: int) -> bool:
        if n > len(self._free):
            return False
        return (self.unit_budget is None or
                self.units_in_use + n * PAGE_UNITS_FULL <= self.unit_budget)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` page ids (refcount 1, full cost), or None (no change)."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if not self.can_alloc(n):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(ids)
        for pid in ids:
            self._ref[pid] = 1
            self._cost[pid] = PAGE_UNITS_FULL
        if self.track_allocs:
            self.alloc_log.extend(ids)
        self.units_in_use += n * PAGE_UNITS_FULL
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        self.peak_units = max(self.peak_units, self.units_in_use)
        return ids

    def retain(self, ids) -> None:
        """Add one reference to each allocated page in ``ids``."""
        for pid in ids:
            self._check(pid, "retain of unknown page")
            if self._ref[pid] == 0:
                raise ValueError(f"retain of free page {pid}")
            self._ref[pid] += 1

    def free(self, ids) -> None:
        """Drop one reference per page; the last reference frees it."""
        for pid in ids:
            self._check(pid, "free of unknown page")
            if pid in self._free_set or self._ref[pid] == 0:
                raise ValueError(f"double free of page {pid}")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self.units_in_use -= self._cost[pid]
                self._free.append(pid)
                self._free_set.add(pid)


# ---------------------------------------------------------------------------
# device-side page surgery (every layer's pool shares one page table)
# ---------------------------------------------------------------------------


_POOL_KEYS = ({"k", "v"}, {"k_elems", "k_scales", "v_elems", "v_scales"})


def is_pool(entry: dict) -> bool:
    """Whether a layer's cache entry is a page pool (else state rows)."""
    return set(entry) in _POOL_KEYS


def _leaves(pool: dict):
    """(key, uint8 view) of every leaf: fp8 and E8M0 leaves are one byte
    per element, and byte views take every indexing op on every device."""
    return [(key, leaf.view(torch.uint8)) for key, leaf in pool.items()]


def _install_pairs(cache: list, prefill_layers: list) -> list:
    """(destination, source) uint8 views of an install, a pair a pool layer
    and leaf: (NP, PS, ...) pool leaves against (1, T, ...) prefill leaves.
    On a uniform stack the pools are slices of ``PagedCache.stack``, so
    the writes land in the tensors the stacked kernels read. ``kpos`` is
    not installed."""
    return [(leaf.view(torch.uint8), lay[key].view(torch.uint8))
            for pool, lay in zip(cache, prefill_layers) if is_pool(pool)
            for key, leaf in pool.items()]


def _install_states(cache: list, prefill_layers: list, slot) -> None:
    """Write a batch-1 prefill's recurrent states into row ``slot`` of
    every state layer."""
    for entry, lay in zip(cache, prefill_layers):
        if is_pool(entry):
            continue
        if slot is None:
            raise ValueError("installing recurrent state needs the slot")
        for key, leaf in entry.items():
            leaf[slot] = lay[key][0]


def install_prefill(cache: list, prefill_layers: list,
                    page_ids: torch.Tensor, page_size: int,
                    slot: Optional[int] = None) -> None:
    """Write one request's prefill cache into its pages ``page_ids`` in
    place, and its recurrent states into decode slot ``slot``'s rows.
    ``prefill_layers`` are the per-layer views (``model.cache_layers``) of
    a batch-1 cache of ``len(page_ids) * page_size`` positions without a
    ring (``serve_full_cache``), so slot t is row t % page_size of page t
    // page_size."""
    n = page_ids.shape[0]
    for dst, src in _install_pairs(cache, prefill_layers):
        dst[page_ids] = src[0].reshape(n, page_size, *src.shape[2:])
    _install_states(cache, prefill_layers, slot)


def install_prefill_offset(cache: list, prefill_layers: list,
                           page_ids: torch.Tensor, page_size: int,
                           offset: int, num_rows: int,
                           slot: Optional[int] = None) -> None:
    """Write a prefill tail that starts mid-page (a partial-page prefix
    hit): row r of ``prefill_layers`` lands at row ``offset + r`` of the
    span of ``page_ids``, for the first ``num_rows`` rows (the rest is
    padding). The caller owns every written page alone (copy-on-write
    first); the first page keeps its cached rows below ``offset``.
    Recurrent states install whole into ``slot``'s rows, as in
    :func:`install_prefill` (prefix sharing implies attention-only
    models, so there are none on this path)."""
    rows = torch.arange(num_rows, device=page_ids.device) + offset
    pidx = page_ids[rows // page_size]
    sidx = rows % page_size
    for dst, src in _install_pairs(cache, prefill_layers):
        dst[pidx, sidx] = src[0, :num_rows]
    _install_states(cache, prefill_layers, slot)


def copy_page(cache: list, src: int, dst: int) -> None:
    """Copy physical page ``src`` -> ``dst`` in every layer's pool (the
    device half of copy-on-write); state rows are per-slot, never
    shared."""
    for pool in cache:
        if is_pool(pool):
            for _, leaf in _leaves(pool):
                leaf[dst] = leaf[src]


def extract_seq(cache: list, page_ids: torch.Tensor,
                slot: Optional[int] = None) -> list:
    """Snapshot pages ``page_ids`` of every pool and, with ``slot``, that
    slot's state rows (swap-style preemption: restoring the exact bytes
    keeps generation bit-identical)."""
    out = []
    for entry in cache:
        if is_pool(entry):
            out.append({key: leaf.index_select(0, page_ids)
                        for key, leaf in _leaves(entry)})
        else:
            out.append(None if slot is None else
                       {key: leaf[slot].clone()
                        for key, leaf in entry.items()})
    return out


def merge_snapshots(a, b: list) -> list:
    """Concatenate two :func:`extract_seq` snapshots along the page axis
    (``a`` may be None: a swap that owned no page exclusively). State rows
    keep ``a``'s."""
    if a is None:
        return b
    return [{key: torch.cat([sa[key], sb[key]]) for key in sa}
            if sa is not None and is_pool(sa) else sa
            for sa, sb in zip(a, b)]


def restore_seq(cache: list, snapshot: list, page_ids: torch.Tensor,
                slot: Optional[int] = None) -> None:
    """Inverse of :func:`extract_seq` onto freshly allocated pages and,
    with ``slot``, the slot's state rows."""
    for entry, snap in zip(cache, snapshot):
        if is_pool(entry):
            for key, leaf in _leaves(entry):
                leaf[page_ids] = snap[key]
        elif slot is not None and snap is not None:
            for key, leaf in entry.items():
                leaf[slot] = snap[key]


def snapshot_geometry(cache: list, layout: list, num_pages: int) -> list:
    """(dtype name, shape) of each snapshot leaf over ``num_pages`` listed
    pages; ``layout`` is ``model.reference_cache_leaves``. The names are
    numpy's (``float8_e4m3fn``, ``uint8``, ``bfloat16``), as snapshots
    record them."""
    out = []
    for key, layers, stacked in layout:
        pool = cache[layers[0]][key]
        lead = (len(layers),) if stacked else ()
        out.append((str(pool.dtype).removeprefix("torch."),
                    lead + (num_pages, *pool.shape[1:])))
    return out


def extract_leaves(cache: list, layout: list,
                   page_ids: torch.Tensor) -> list:
    """The bytes of pages ``page_ids`` as snapshot leaves (uint8, one a
    ``layout`` entry; a stacked leaf has the layer axis first)."""
    out = []
    for key, layers, stacked in layout:
        rows = [cache[li][key].view(torch.uint8).index_select(0, page_ids)
                for li in layers]
        out.append(torch.stack(rows) if stacked else rows[0])
    return out


def restore_leaves(cache: list, layout: list, leaves: list,
                   page_ids: torch.Tensor) -> None:
    """Inverse of :func:`extract_leaves` onto pages ``page_ids``."""
    for (key, layers, stacked), data in zip(layout, leaves):
        for j, li in enumerate(layers):
            cache[li][key].view(torch.uint8)[page_ids] = (
                data[j] if stacked else data)


def _nbytes(entries) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for entry in entries for leaf in entry.values())


def cache_nbytes(cache: list) -> int:
    """Total bytes of every cache leaf (pools and recurrent state)."""
    return _nbytes(cache)


def pool_page_nbytes(cache: list, num_pages: int) -> int:
    """Bytes one page costs across all attention layers."""
    total = _nbytes(e for e in cache if is_pool(e))
    if total % num_pages:
        raise ValueError("pool bytes not divisible by page count")
    return total // num_pages


def state_nbytes(cache: list) -> int:
    """Bytes of the per-slot recurrent state (not paged)."""
    return _nbytes(e for e in cache if not is_pool(e))
