"""Block-paged KV-cache bookkeeping: page pool allocator + prefix sharing.

A copy of the JAX package's ``repro/serve/paged.py`` (pure Python, so the
code is carried over verbatim; only this docstring's cross-references
differ).  ``tests/test_torch_serve.py`` holds the two copies equal.

A dense serving engine gives every slot a
contiguous ``max_len`` cache, so resident memory scales with
``slots x max_len`` regardless of how much of each slot is actually filled,
and two slots serving the same system prompt store (and recompute) the
prompt's K/V twice.  The paged engine replaces the per-slot caches with ONE
device pool of fixed-size pages plus a per-slot *page table* mapping logical
page ``t`` (absolute positions ``[t*ps, (t+1)*ps)``) to a physical page.

This module owns everything about pages that is *host-side and exact*:

* **Allocation** — a free list over physical pages ``1..P-1``.  Physical
  page ``0`` is reserved as the *trash page*: inactive-slot writes and
  pad-row writes are redirected there, so a stale slot can never scribble
  on a page that has since been reallocated (the paged analogue of the
  dense engine's "idempotent junk at a stale position").
* **Prefix sharing** — full pages wholly covered by a prompt are registered
  in a hash-chained prefix map (page ``i``'s node is keyed by its parent
  node + its ``page_size`` tokens, vLLM-style).  A later admission walks
  the chain and *reuses* matching pages: their refcount rises, the slot's
  page table points at them, and prefill restarts at the divergence point.
  At least the last prompt token is always recomputed (the admission step
  needs its logits for the first emitted token), so a fully-cached prompt
  still keeps one private page.
* **Refcounting** — ``ref[p]`` counts the slots whose tables reference
  physical page ``p``; a page is freed only when its refcount reaches zero
  AND it is not retained by the prefix map.  Cached-but-unreferenced pages
  are *evictable* (LRU, leaf-first along the chain) when the free list runs
  dry.
* **Swap epochs** — cached prefix K/V was computed under one params
  version; after a params hot-swap it is stale (a new
  admission must see the NEW params, per the versioned swap oracle), so
  :meth:`bump_epoch` drops the whole prefix map.  Pages still referenced by
  in-flight slots live on (their slots keep decoding over the old-prefix
  cache, exactly like a dense slot that lives through a swap); unreferenced
  ones return to the free list.

Everything here is plain Python over host ints — deterministic by
construction (insertion-ordered dicts, explicit LRU clock).  The device
side (pool tensors, gathers, scatters) lives in
``repro_torch.nn.attention`` / ``repro_torch.models.transformer``.
"""

from __future__ import annotations

import dataclasses

TRASH_PAGE = 0


def pages_for(positions: int, page_size: int) -> int:
    """Pages needed to hold ``positions`` tokens (ceil division)."""
    return -(-positions // page_size)


@dataclasses.dataclass
class Admission:
    """One slot's page grant: the logical->physical table row and how much
    of it was satisfied from the prefix cache."""

    pages: list          # physical page per logical page, in order
    shared: int          # leading pages reused from the prefix cache
    start: int           # absolute position prefill resumes at (shared*ps)
    registered: list     # pages THIS admission added to the prefix map

    def as_meta(self):
        return {"pages": list(self.pages), "shared": self.shared,
                "start": self.start, "registered": list(self.registered)}

    @classmethod
    def from_meta(cls, m):
        return cls(pages=list(m["pages"]), shared=int(m["shared"]),
                   start=int(m["start"]), registered=list(m["registered"]))


@dataclasses.dataclass
class _Node:
    """A cached prefix page: physical page + its position in the hash chain."""

    page: int
    key: tuple           # (parent_page, tokens...) — the map key
    parent: int          # parent physical page (-1 at the chain root)
    children: int        # cached children (evictable only at 0)
    last_used: int       # LRU clock stamp


class PageAllocator:
    """Free list + refcounts + prefix map over ``num_pages`` physical pages.

    Page ``0`` is the reserved trash page; pages ``1..num_pages-1`` are
    allocatable.  All methods are host-side and O(pages touched).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + trash")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reset()

    def reset(self):
        self._free = list(range(1, self.num_pages))   # LIFO: pop from end
        self.ref = [0] * self.num_pages
        self._nodes = {}          # key -> _Node
        self._by_page = {}        # physical page -> _Node (cached pages only)
        self.epoch = 0
        self._clock = 0
        self.in_use = 0           # pages with ref > 0 or cached
        self.peak = 0
        self.hits = 0             # admissions that reused >= 1 page
        self.misses = 0
        self.evictions = 0

    # -- invariant helpers (the property suite's observation surface) --------

    def free_pages(self) -> list:
        return list(self._free)

    def cached_pages(self) -> list:
        return sorted(self._by_page)

    def check_invariants(self):
        """Raise AssertionError if the pool books don't balance."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert TRASH_PAGE not in free, "trash page leaked into the free list"
        for p in free:
            assert self.ref[p] == 0, f"free page {p} has refcount {self.ref[p]}"
            assert p not in self._by_page, f"free page {p} still cached"
        busy = {p for p in range(1, self.num_pages)
                if self.ref[p] > 0 or p in self._by_page}
        assert not (free & busy)
        assert len(free) + len(busy) == self.num_pages - 1, \
            "free + in-use pages do not conserve the pool"
        assert self.in_use == len(busy)
        for node in self._nodes.values():
            assert self._by_page.get(node.page) is node
            kids = sum(1 for n in self._nodes.values()
                       if n.parent == node.page)
            assert kids == node.children

    # -- internals -----------------------------------------------------------

    def _take_page(self):
        """Pop a free page, evicting unreferenced cached prefixes (LRU,
        leaf-first) if the free list is dry.  Returns None when every page
        is pinned by a live slot."""
        if not self._free:
            evictable = [n for n in self._nodes.values()
                         if self.ref[n.page] == 0 and n.children == 0]
            if not evictable:
                return None
            victim = min(evictable, key=lambda n: (n.last_used, n.page))
            self._drop_node(victim)
            self.evictions += 1
            self.in_use -= 1
            self._free.append(victim.page)
        return self._free.pop()

    def _drop_node(self, node):
        del self._nodes[node.key]
        del self._by_page[node.page]
        if node.parent in self._by_page:
            self._by_page[node.parent].children -= 1

    def _release_page(self, page):
        self.ref[page] -= 1
        assert self.ref[page] >= 0, f"page {page} over-released"
        if self.ref[page] == 0 and page not in self._by_page:
            self._free.append(page)
            self.in_use -= 1

    # -- the lifecycle -------------------------------------------------------

    def admit(self, prompt, total_positions: int):
        """Grant pages for one slot: ``prompt`` (iterable of token ints) and
        ``total_positions`` — the highest cache position the slot may ever
        write, plus one (prompt + decode budget, capped at ``max_len - 1``).

        Returns an :class:`Admission` (page table row, shared-page count,
        prefill restart position), or ``None`` if the pool cannot grant the
        pages even after evicting every unpinned cached prefix — the caller
        leaves the request queued.

        Prefix walk: match cached full pages of the prompt, capped at
        ``len(prompt) - 1`` tokens so the admission step always has at least
        one real suffix row to read first-token logits from.  The remaining
        *full prompt* pages are registered as new prefix nodes (this epoch),
        making the NEXT identical prompt a hit — including one admitted on
        the same tick, whose prefill gathers the pages this admission's
        scatter just wrote.
        """
        prompt = [int(t) for t in prompt]    # np.int64 would poison the
        # node keys and the JSON-serializable snapshot alike
        plen = len(prompt)
        ps = self.page_size
        total_positions = max(total_positions, plen)
        need = pages_for(total_positions, ps)

        # Walk the prefix chain over full pages (never the whole prompt).
        max_shared = min(plen - 1, plen // ps * ps) // ps if plen else 0
        shared_pages = []
        parent = -1
        for i in range(max_shared):
            key = (parent, tuple(prompt[i * ps:(i + 1) * ps]))
            node = self._nodes.get(key)
            if node is None:
                break
            shared_pages.append(node.page)
            node.last_used = self._clock
            self._clock += 1
            parent = node.page

        pages = []
        for p in shared_pages:
            # cached pages are already counted in in_use at refcount zero
            self.ref[p] += 1
            pages.append(p)
        taken = []
        for _ in range(need - len(shared_pages)):
            p = self._take_page()
            if p is None:
                for q in taken:
                    self.ref[q] -= 1
                    self._free.append(q)
                    self.in_use -= 1
                for q in shared_pages:
                    self._release_page(q)
                return None
            self.ref[p] = 1
            self.in_use += 1
            taken.append(p)
            pages.append(p)

        # Register the not-yet-cached full prompt pages as prefix nodes.
        registered = []
        full = min(plen - 1, plen // ps * ps) // ps if plen else 0
        for i in range(len(shared_pages), full):
            key = (parent, tuple(prompt[i * ps:(i + 1) * ps]))
            page = pages[i]
            node = _Node(page=page, key=key, parent=parent, children=0,
                         last_used=self._clock)
            self._clock += 1
            self._nodes[key] = node
            self._by_page[page] = node
            if parent in self._by_page:
                self._by_page[parent].children += 1
            registered.append(page)
            parent = page

        if shared_pages:
            self.hits += 1
        else:
            self.misses += 1
        self.peak = max(self.peak, self.in_use)
        return Admission(pages=pages, shared=len(shared_pages),
                         start=len(shared_pages) * ps, registered=registered)

    def release(self, admission: Admission):
        """Drop one slot's references.  Cached prefix pages survive at
        refcount zero (future hits); purely private pages go back to the
        free list."""
        for p in admission.pages:
            self._release_page(p)

    def bump_epoch(self):
        """Params hot-swap: every cached prefix was computed under the old
        weights and must never be hit again.  Drop the whole map; pages no
        live slot references return to the free list."""
        self.epoch += 1
        for node in list(self._nodes.values()):
            self._drop_node(node)
            if self.ref[node.page] == 0:
                self._free.append(node.page)
                self.in_use -= 1

    # -- checkpoint carry ----------------------------------------------------

    def snapshot(self):
        """JSON-serializable state (the engine's fused-checkpoint meta)."""
        return {
            "num_pages": self.num_pages, "page_size": self.page_size,
            "free": list(self._free), "ref": list(self.ref),
            "epoch": self.epoch, "clock": self._clock,
            "in_use": self.in_use, "peak": self.peak,
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions,
            "nodes": [{"page": n.page, "parent": n.parent,
                       "tokens": list(n.key[1]), "children": n.children,
                       "last_used": n.last_used}
                      for n in self._nodes.values()],
        }

    @classmethod
    def from_snapshot(cls, snap):
        a = cls(snap["num_pages"], snap["page_size"])
        a._free = list(snap["free"])
        a.ref = list(snap["ref"])
        a.epoch = snap["epoch"]
        a._clock = snap["clock"]
        a.in_use = snap["in_use"]
        a.peak = snap["peak"]
        a.hits = snap["hits"]
        a.misses = snap["misses"]
        a.evictions = snap["evictions"]
        for m in snap["nodes"]:
            key = (m["parent"], tuple(int(t) for t in m["tokens"]))
            node = _Node(page=m["page"], key=key, parent=m["parent"],
                         children=m["children"], last_used=m["last_used"])
            a._nodes[key] = node
            a._by_page[node.page] = node
        return a
