"""Prefix cache: a token-radix tree of shared, ref-counted MX cache pages
(port of ``repro.serve.prefix_cache``).

Each node owns one page: its key is the ``page_size``-token tuple of that
page's slice of the prompt, and its path from the root spells the whole
prefix. The K/V rows of a page are a pure function of the token prefix up
to its end, so prompts sharing a page-aligned head share its physical
pages.

Ownership (all accounting lives in :class:`~.kv_cache.PagePool`): the
tree holds one reference per node's page while the node exists;
:meth:`acquire` retains one reference per matched page for the
requesting sequence; :meth:`evict` drops least-recently-used leaves that
nobody else references. :meth:`export_state` and :meth:`import_state`
carry the tree through a snapshot in the reference's structure.

Partial-page entries (monolithic prefill only): ``insert(partial=True)``
also registers a prompt's non-aligned tail on the node of its last full
page, holding one tree reference on the page that stores it, and
``acquire`` extends a hit into such an entry, so the hit may end
mid-page. The tree's reference makes the owner's next write into that
page copy it first. Chunked prefill starts its chunks on page boundaries
and asks for full pages only (``acquire(full_only=True)``).
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kv_cache import PagePool


class _Node:
    """One full page of cached prompt tokens."""

    __slots__ = ("key", "page", "children", "parent", "last_use", "partial")

    def __init__(self, key: Tuple[int, ...], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page  # physical page id (None only for the root)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0
        # partial-page entries off this prefix: tail tokens (0 < len <
        # page_size) -> [page id, last_use]; the page's first len(tail)
        # rows hold the tail's K/V, the rest is masked on every read
        self.partial: Dict[Tuple[int, ...], List[int]] = {}


class PrefixCache:
    """Radix tree of page-granular prompt prefixes over a shared pool."""

    def __init__(self, pool: PagePool, page_size: int):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.pool = pool
        self.page_size = page_size
        self._root = _Node((), None, None)
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.dedupes = 0  # insert repointed a hit-cap duplicate page
        self.partial_inserts = 0  # partial-page entries registered

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _nodes_with_root(self):
        yield self._root
        yield from self._iter_nodes()

    @property
    def pages_held(self) -> List[int]:
        """The physical pages the tree holds a reference on, one entry a
        node or partial entry."""
        held = [n.page for n in self._iter_nodes()]
        for node in self._nodes_with_root():
            held.extend(ent[0] for ent in node.partial.values())
        return held

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    @property
    def num_partial_entries(self) -> int:
        return sum(len(n.partial) for n in self._nodes_with_root())

    def _chunks(self, prompt, n: int):
        ps = self.page_size
        for i in range(n):
            yield i, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def acquire(self, prompt: np.ndarray,
                full_only: bool = False) -> Tuple[List[int], int]:
        """Longest prefix hit for ``prompt``: full pages, then the longest
        matching partial entry at the node where they stop (unless
        ``full_only``), so ``cached_tokens`` need not be a page multiple.

        Returns (page_ids, cached_tokens), retaining one pool reference per
        returned page for the caller. The hit is capped at
        ``len(prompt) - 1`` tokens: at least one prompt token must be
        prefilled to produce the first sampled token's logits. A caller of
        a partial hit copies the partial page before it writes the rest of
        its rows, and masks the rows past ``cached_tokens``. Stat-free:
        the scheduler reports an admitted lookup via :meth:`record_lookup`.
        """
        cap = (len(prompt) - 1) // self.page_size
        node, pages = self._root, []
        for _, key in self._chunks(prompt, cap):
            child = node.children.get(key)
            if child is None:
                break
            self.pool.retain([child.page])
            self._clock += 1
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        cached = len(pages) * self.page_size
        if not full_only and node.partial:
            budget = (len(prompt) - 1) - cached
            best = None
            for key in node.partial:
                if (len(key) <= budget
                        and (best is None or len(key) > len(best))
                        and key == tuple(int(t) for t in
                                         prompt[cached:cached + len(key)])):
                    best = key
            if best is not None:
                ent = node.partial[best]
                self.pool.retain([ent[0]])
                self._clock += 1
                ent[1] = self._clock
                pages.append(ent[0])
                cached += len(best)
        return pages, cached

    def record_lookup(self, cached_tokens: int) -> None:
        """Count one admitted request's lookup outcome in the stats."""
        self.lookups += 1
        if cached_tokens:
            self.hits += 1
            self.hit_tokens += cached_tokens

    def insert(self, prompt: np.ndarray, pages: List[int],
               partial: bool = False) -> int:
        """Register a freshly prefilled prompt's full pages in the tree.

        Entry ``i`` of ``pages`` must hold the K/V of prompt tokens
        ``[i*ps, (i+1)*ps)``. Existing nodes are kept (first writer wins:
        the contents are identical); each new node retains one reference
        that outlives the inserting sequence. When an existing node covers
        a page the sequence holds a different (private, identical) copy
        of — the hit-cap duplicate — the caller's table entry is repointed
        to the tree's page in place and the duplicate released. Returns
        the number of nodes added.

        ``partial=True`` also registers the prompt's non-aligned tail as a
        partial entry on its last full page's node, retaining one tree
        reference on the sequence's page that holds it (first writer
        wins: an existing entry for the same tail is left alone).
        """
        node, created = self._root, 0
        n_full = len(prompt) // self.page_size
        for i, key in self._chunks(prompt, n_full):
            child = node.children.get(key)
            if child is None:
                self.pool.retain([pages[i]])
                child = _Node(key, pages[i], node)
                node.children[key] = child
                self._clock += 1
                child.last_use = self._clock
                created += 1
            elif pages[i] != child.page:
                self.pool.retain([child.page])
                self.pool.free([pages[i]])
                pages[i] = child.page
                self.dedupes += 1
            node = child
        tail = tuple(int(t) for t in prompt[n_full * self.page_size:])
        if partial and tail and n_full < len(pages) \
                and tail not in node.partial:
            self.pool.retain([pages[n_full]])
            self._clock += 1
            node.partial[tail] = [pages[n_full], self._clock]
            self.partial_inserts += 1
        return created

    def release_partial(self, page_id: int) -> bool:
        """Drop the partial entry holding ``page_id``, if any (True when
        one went). The engine's fallback when a write needs a page whose
        other holder is only a partial entry and no page is left for the
        copy: it loses a future hit, never data another holder reads."""
        for nd in self._nodes_with_root():
            for key, ent in nd.partial.items():
                if ent[0] == page_id:
                    del nd.partial[key]
                    self.pool.free([page_id])
                    self.evictions += 1
                    return True
        return False

    def evictable_count(self) -> int:
        """Pages :meth:`evict` could free now: nodes whose whole subtree is
        unpinned (a node can only fall after all its descendants), partial
        entries counting as leaves."""

        def walk(node):
            total, all_ev = 0, True
            for child in node.children.values():
                c_total, c_ev = walk(child)
                total += c_total
                all_ev = all_ev and c_ev
            for page, _ in node.partial.values():
                if self.pool.ref(page) == 1:
                    total += 1
                else:
                    all_ev = False
            if node is self._root:
                return total, False
            ev = all_ev and self.pool.ref(node.page) == 1
            return total + (1 if ev else 0), ev

        return walk(self._root)[0]

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages by dropping LRU unreferenced leaves
        (only pages the tree alone holds); partial entries are leaves in
        their own right. Evicting a leaf can expose its parent, which joins
        the same LRU heap. Returns pages freed."""
        def candidate(nd):
            return (not nd.children and not nd.partial
                    and self.pool.ref(nd.page) == 1)

        tick = iter(range(1 << 30))  # heap tiebreak (nodes don't compare)
        heap = [(nd.last_use, next(tick), nd, None)
                for nd in self._iter_nodes() if candidate(nd)]
        for nd in self._nodes_with_root():
            for key, ent in nd.partial.items():
                if self.pool.ref(ent[0]) == 1:
                    heap.append((ent[1], next(tick), nd, key))
        heapq.heapify(heap)
        freed = 0
        while freed < need and heap:
            _, _, nd, key = heapq.heappop(heap)
            if key is not None:
                self.pool.free([nd.partial.pop(key)[0]])
                self.evictions += 1
                freed += 1
                if nd is not self._root and candidate(nd):
                    heapq.heappush(heap, (nd.last_use, next(tick), nd, None))
                continue
            del nd.parent.children[nd.key]
            self.pool.free([nd.page])
            self.evictions += 1
            freed += 1
            parent = nd.parent
            if parent is not self._root and candidate(parent):
                heapq.heappush(heap, (parent.last_use, next(tick), parent,
                                      None))
        return freed

    # -- persistence ---------------------------------------------------------

    def export_state(self) -> Dict:
        """The tree's structure, without page bytes: nodes in BFS order,
        each with its parent's index (-1: the root), so parents precede
        children; page ids are this pool's physical ids (the engine saves
        the pages' bytes beside them and remaps the ids on import), and
        the ``last_use`` clocks keep the LRU order across a restart.
        ``partials`` lists the partial entries, each with its node's index
        (-1: the root)."""
        nodes, partials = [], []
        index = {id(self._root): -1}
        queue = deque(self._root.children.values())
        while queue:
            node = queue.popleft()
            index[id(node)] = len(nodes)
            nodes.append({"parent": index[id(node.parent)],
                          "key": list(node.key), "page": int(node.page),
                          "last_use": int(node.last_use)})
            queue.extend(node.children.values())
        for nd in self._nodes_with_root():
            for tail, (page, last_use) in nd.partial.items():
                partials.append({"node": index[id(nd)], "tail": list(tail),
                                 "page": int(page),
                                 "last_use": int(last_use)})
        return {"page_size": self.page_size, "nodes": nodes,
                "partials": partials}

    def check_state(self, state: Dict) -> None:
        """Raise unless :meth:`import_state` can take ``state`` now."""
        if self._root.children or self._root.partial:
            raise RuntimeError("import_state requires an empty prefix cache")
        if state["page_size"] != self.page_size:
            raise ValueError(
                f"snapshot page_size {state['page_size']} != "
                f"engine page_size {self.page_size}")

    def import_state(self, state: Dict, page_map: Dict[int, int]) -> int:
        """Rebuild the tree of :meth:`export_state` over the pages that
        ``page_map`` maps the exported ids to, whose bytes the engine has
        restored. The caller hands over one pool reference a page (its
        ``alloc`` reference), which becomes the node's, as if ``insert``
        had grown the tree. Needs an empty tree. Returns the entries
        imported (nodes and partial entries)."""
        self.check_state(state)
        by_index = {-1: self._root}
        for i, entry in enumerate(state["nodes"]):
            parent = by_index[entry["parent"]]
            key = tuple(int(t) for t in entry["key"])
            node = _Node(key, page_map[int(entry["page"])], parent)
            node.last_use = int(entry["last_use"])
            parent.children[key] = node
            by_index[i] = node
        for ent in state["partials"]:
            by_index[int(ent["node"])].partial[
                tuple(int(t) for t in ent["tail"])] = [
                    page_map[int(ent["page"])], int(ent["last_use"])]
            self.partial_inserts += 1
        self._clock = max([self._clock]
                          + [int(n["last_use"]) for n in state["nodes"]]
                          + [int(e["last_use"]) for e in state["partials"]])
        return len(state["nodes"]) + len(state["partials"])

    def stats(self) -> Dict[str, int]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_evictions": self.evictions,
            "prefix_dedupes": self.dedupes,
            "prefix_nodes": self.num_nodes,
            "prefix_partial_entries": self.num_partial_entries,
            "prefix_partial_inserts": self.partial_inserts,
        }
