"""Shared-prefix KV cache: a trie from prompt chunks to physical pages,
the port of the JAX package's ``serve/prefix_cache.py``.

The K/V rows of a prompt position depend only on the tokens at and
before it, so two prompts that agree on their first ``k * page_size``
tokens produce the same KV pages for those k slots (same weights, same
absolute positions, a deterministic prefill).  The cache maps
page-aligned prompt chunks to the physical page that already holds
their K/V, so a cache-hit admission points its page table at the shared
pages and routes the prefill's stores for those slots to the trash page
0: a table edit, not a new program.

A trie keyed on full ``page_size``-token chunk tuples: a node's path
spells the whole token prefix, the dependency closure of its page.
Partially filled tail pages are cached too, keyed by their exact tail
tuple under the parent node; the owner of a cached tail page appends
into it on its first decode step, so the tail entry is what makes
copy-on-write real traffic (refcount 2: the owner and the cache).

The cache holds its own reference on every page it keeps
(``PageAllocator.share`` on insert, ``free`` on eviction).  Eviction is
leaf-first in LRU order and takes only pages the cache alone still
holds.  Host bookkeeping only: no tensors.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefixMatch:
    """One lookup's result: the shared pages covering the longest
    cached prefix (full chunks first, optionally one tail partial),
    the token count they cover, and the trie path behind them (so
    ``acquire`` can touch LRU state without re-walking)."""

    pages: list
    tokens_covered: int
    nodes: list
    partial_key: tuple | None = None

    @property
    def slots(self) -> int:
        return len(self.pages)


class _Node:
    __slots__ = ("page", "children", "partials", "touched")

    def __init__(self, page=None):
        self.page = page                  # physical page id (None: root)
        self.children: dict = {}          # chunk tuple -> _Node
        self.partials: dict = {}          # tail tuple -> [page, touched]
        self.touched = 0


class PrefixCache:
    """The trie + its refcount holds.  One instance per engine run
    (it holds references into that run's ``PageAllocator``)."""

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _Node()
        self._tick = 0
        self.cached_pages = 0
        self.evicted_pages = 0

    # -- lookup -------------------------------------------------------

    def _chunks(self, tokens) -> tuple[list[tuple], tuple]:
        ps = self.page_size
        toks = tuple(int(t) for t in tokens)
        full = len(toks) // ps
        return ([toks[j * ps:(j + 1) * ps] for j in range(full)],
                toks[full * ps:])

    def match(self, tokens) -> PrefixMatch:
        """Pure peek (no refcounts, no LRU motion): the longest cached
        prefix of ``tokens``, full chunks then at most one exact-tail
        partial.  Admission gates on it, then ``acquire``s the same
        match in the same scheduler iteration."""
        chunks, tail = self._chunks(tokens)
        node = self.root
        pages: list = []
        nodes: list = [node]
        for c in chunks:
            nxt = node.children.get(c)
            if nxt is None:
                return PrefixMatch(pages, len(pages) * self.page_size,
                                   nodes)
            node = nxt
            pages.append(node.page)
            nodes.append(node)
        covered = len(pages) * self.page_size
        if tail and tail in node.partials:
            pages = pages + [node.partials[tail][0]]
            return PrefixMatch(pages, covered + len(tail), nodes,
                               partial_key=tail)
        return PrefixMatch(pages, covered, nodes)

    def acquire(self, m: PrefixMatch) -> list:
        """Take one reference per shared page for an admitted request
        (released through the request's normal ``allocator.free`` at
        retirement) and touch the path's LRU clocks."""
        self._tick += 1
        for node in m.nodes:
            node.touched = self._tick
        if m.partial_key is not None:
            m.nodes[-1].partials[m.partial_key][1] = self._tick
        self.allocator.share(m.pages)
        return list(m.pages)

    # -- insert -------------------------------------------------------

    def insert(self, tokens, pages, length: int) -> int:
        """Cache the pages of a freshly-prefilled request: one trie
        node per full chunk, one partial entry for a non-empty tail.
        ``pages[j]`` must be the physical page of slot j.  Chunks
        already cached keep their canonical page (the caller's copy
        stays private).  Returns pages newly retained."""
        chunks, tail = self._chunks(tokens[:length])
        self._tick += 1
        node = self.root
        node.touched = self._tick
        added = 0
        walked = True
        for j, c in enumerate(chunks):
            nxt = node.children.get(c)
            if nxt is None:
                page = pages[j]
                if page == 0:
                    walked = False
                    break           # never cache the trash page
                nxt = _Node(page)
                self.allocator.share([page])
                node.children[c] = nxt
                added += 1
            nxt.touched = self._tick
            node = nxt
        if walked and tail:
            tslot = len(chunks)
            if tslot < len(pages) and tail not in node.partials:
                page = pages[tslot]
                if page != 0:
                    self.allocator.share([page])
                    node.partials[tail] = [page, self._tick]
                    added += 1
        self.cached_pages += added
        return added

    # -- eviction -----------------------------------------------------

    def _evictable(self):
        """Leaf candidates whose page only the cache still holds:
        ``(touched, kind, parent, key)`` rows — partials and childless,
        partial-free nodes (evicting leaves first keeps every retained
        node's path intact)."""
        out = []

        def walk(node):
            for key, entry in node.partials.items():
                if self.allocator.refcount(entry[0]) == 1:
                    out.append((entry[1], "partial", node, key))
            for key, child in node.children.items():
                if not child.children and not child.partials:
                    if self.allocator.refcount(child.page) == 1:
                        out.append((child.touched, "node", node, key))
                else:
                    walk(child)

        walk(self.root)
        return out

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages back to the pool, coldest leaves
        first; returns how many were actually freed.  Evicting a leaf
        can expose its parent, so the scan repeats until satisfied or
        dry."""
        freed = 0
        while freed < need:
            cands = self._evictable()
            if not cands:
                break
            cands.sort(key=lambda c: c[0])
            for _, kind, parent, key in cands:
                if freed >= need:
                    break
                if kind == "partial":
                    page = parent.partials.pop(key)[0]
                else:
                    page = parent.children.pop(key).page
                self.allocator.free([page])
                freed += 1
        self.cached_pages -= freed
        self.evicted_pages += freed
        return freed
