"""Prefix cache: a token-radix tree of shared, ref-counted MX cache pages
(port of ``repro.serve.prefix_cache``, full pages only).

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
carry the tree through a snapshot in the reference's structure. The
chunked prefill the port runs only consumes page-aligned hits, so the
reference's partial-page entries (a monolithic-prefill feature, ROADMAP
A4) are not carried over: an export lists none, and an import refuses a
snapshot that has some.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kv_cache import PagePool


class _Node:
    """One full page of cached prompt tokens."""

    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key: Tuple[int, ...], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page  # physical page id (None only for the root)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0


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

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    @property
    def pages_held(self) -> List[int]:
        """The physical pages the tree holds a reference on, one entry a
        node."""
        return [n.page for n in self._iter_nodes()]

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def _chunks(self, prompt, n: int):
        ps = self.page_size
        for i in range(n):
            yield i, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def acquire(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest full-page prefix hit for ``prompt``.

        Returns (page_ids, cached_tokens), retaining one pool reference per
        returned page for the caller. The hit is capped at
        ``len(prompt) - 1`` tokens: at least one prompt token must be
        prefilled to produce the first sampled token's logits. Stat-free:
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
        return pages, len(pages) * self.page_size

    def record_lookup(self, cached_tokens: int) -> None:
        """Count one admitted request's lookup outcome in the stats."""
        self.lookups += 1
        if cached_tokens:
            self.hits += 1
            self.hit_tokens += cached_tokens

    def insert(self, prompt: np.ndarray, pages: List[int]) -> int:
        """Register a freshly prefilled prompt's full pages in the tree.

        Entry ``i`` of ``pages`` must hold the K/V of prompt tokens
        ``[i*ps, (i+1)*ps)``. Existing nodes are kept (first writer wins:
        the contents are identical); each new node retains one reference
        that outlives the inserting sequence. When an existing node covers
        a page the sequence holds a different (private, identical) copy
        of — the hit-cap duplicate — the caller's table entry is repointed
        to the tree's page in place and the duplicate released. Returns
        the number of nodes added.
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
        return created

    def evictable_count(self) -> int:
        """Pages :meth:`evict` could free now: nodes whose whole subtree is
        unpinned (a node can only fall after all its descendants)."""

        def walk(node):
            total, all_ev = 0, True
            for child in node.children.values():
                c_total, c_ev = walk(child)
                total += c_total
                all_ev = all_ev and c_ev
            if node is self._root:
                return total, False
            ev = all_ev and self.pool.ref(node.page) == 1
            return total + (1 if ev else 0), ev

        return walk(self._root)[0]

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages by dropping LRU unreferenced leaves
        (only pages the tree alone holds); evicting a leaf can expose its
        parent, which joins the same LRU heap. Returns pages freed."""
        def candidate(nd):
            return not nd.children and self.pool.ref(nd.page) == 1

        tick = iter(range(1 << 30))  # heap tiebreak (nodes don't compare)
        heap = [(nd.last_use, next(tick), nd)
                for nd in self._iter_nodes() if candidate(nd)]
        heapq.heapify(heap)
        freed = 0
        while freed < need and heap:
            _, _, nd = heapq.heappop(heap)
            del nd.parent.children[nd.key]
            self.pool.free([nd.page])
            self.evictions += 1
            freed += 1
            parent = nd.parent
            if parent is not self._root and candidate(parent):
                heapq.heappush(heap, (parent.last_use, next(tick), parent))
        return freed

    # -- persistence ---------------------------------------------------------

    def export_state(self) -> Dict:
        """The tree's structure, without page bytes: nodes in BFS order,
        each with its parent's index (-1: the root), so parents precede
        children; page ids are this pool's physical ids (the engine saves
        the pages' bytes beside them and remaps the ids on import), and
        the ``last_use`` clocks keep the LRU order across a restart."""
        nodes = []
        index = {id(self._root): -1}
        queue = deque(self._root.children.values())
        while queue:
            node = queue.popleft()
            index[id(node)] = len(nodes)
            nodes.append({"parent": index[id(node.parent)],
                          "key": list(node.key), "page": int(node.page),
                          "last_use": int(node.last_use)})
            queue.extend(node.children.values())
        return {"page_size": self.page_size, "nodes": nodes,
                "partials": []}

    def check_state(self, state: Dict) -> None:
        """Raise unless :meth:`import_state` can take ``state`` now."""
        if self._root.children:
            raise RuntimeError("import_state requires an empty prefix cache")
        if state["page_size"] != self.page_size:
            raise ValueError(
                f"snapshot page_size {state['page_size']} != "
                f"engine page_size {self.page_size}")
        if state["partials"]:
            raise ValueError(
                f"snapshot holds {len(state['partials'])} partial-page "
                "entries, which come with monolithic prefill (ROADMAP A4, "
                "not ported to repro_torch yet)")

    def import_state(self, state: Dict, page_map: Dict[int, int]) -> int:
        """Rebuild the tree of :meth:`export_state` over the pages that
        ``page_map`` maps the exported ids to, whose bytes the engine has
        restored. The caller hands over one pool reference a page (its
        ``alloc`` reference), which becomes the node's, as if ``insert``
        had grown the tree. Needs an empty tree. Returns the node count."""
        self.check_state(state)
        by_index = {-1: self._root}
        for i, entry in enumerate(state["nodes"]):
            parent = by_index[entry["parent"]]
            key = tuple(int(t) for t in entry["key"])
            node = _Node(key, page_map[int(entry["page"])], parent)
            node.last_use = int(entry["last_use"])
            parent.children[key] = node
            by_index[i] = node
        self._clock = max([self._clock]
                          + [int(n["last_use"]) for n in state["nodes"]])
        return len(state["nodes"])

    def stats(self) -> Dict[str, int]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_evictions": self.evictions,
            "prefix_dedupes": self.dedupes,
            "prefix_nodes": self.num_nodes,
        }
