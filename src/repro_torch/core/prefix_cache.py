"""Two-tier radix prefix cache: token-granular copy-on-write KV page sharing
across pools, with **in-place host-tier serving** (the port's copy of the
JAX package's ``core/prefix_cache.py``; the tree, its counters and its
statistics are the reference's, over the port's :class:`DualPool` and
:class:`TransferEngine`).

Multi-turn chat and agent workloads re-prefill identical system prompts and
conversation history on every request.  This module keeps finished requests'
KV pages in a radix tree so a new request can skip prefilling its longest
cached prefix.  NEO's dual-pool machinery makes the cache two-tier: a cached
page may live in either pool (``node.location``), hot prefixes are promoted
back to HBM through the :class:`TransferEngine`, and LRU eviction *demotes*
device pages to the host pool before dropping them outright — host DRAM as
the KV capacity tier.

Two properties make the host tier a *serving* tier rather than a parking
lot (arXiv 2601.19910's DRAM-as-KV-tier loop, closed):

* ``acquire(target="cpu")`` pins host-resident shared pages **in place** —
  no promotion, no private copy.  A ``cpu``-destined decode row's host
  attention (and the host-prefix partial-prefill path) then gathers the
  prefix directly from the host pool at its absolute positions, so the
  prefix never crosses PCIe (``PrefixCacheStats.inplace_host_hits`` /
  ``host_served_hit_tokens``; ``host_hit_pcie_bytes`` counts the
  host-resident prefix bytes that *did* cross, which the serving gates hold
  at ~0 for cpu-placed rows).
* Nodes are **token-granular**: a leaf may carry a partial tail beyond its
  last full page (``len(node.pages) == ceil(len(node.tokens) / page)``),
  and matching walks at token granularity — prompts sharing a prefix at any
  non-page-aligned length still hit (the tail, and any divergence inside a
  page, are served by copy-on-write).  ``token_granular=False`` restores
  the PR-2 page-aligned behavior for A/B measurement.

Invariants (see ROADMAP architecture note):

* A node with children is page-aligned (a child's tokens start at a page
  boundary of the prefix); only leaves may carry a partial tail.  Splits
  happen at page boundaries; divergence *inside* a page is handled at match
  time by **copy-on-write**: the straddling page is copied into a private
  page for the requester, valid up to the common token count.
* Ownership is per-page reference counts in :class:`PagePool`: the tree holds
  one reference per page it owns; every active reader (request) holds one
  more.  A page returns to the free list only when its last reference drops —
  so preemption/swap-out of one request can never evict a shared page out
  from under a sibling.
* Only pages with ``refcount == 1`` (tree-only) are evictable or relocatable;
  pinned pages (in use by a request) never move.  In particular a node pinned
  in place by a host reader can be neither promoted nor evicted until that
  reader releases it.
* Interior nodes are never dropped while they have children (a child's KV is
  meaningless without its prefix path); they may still be demoted/promoted,
  which moves pages without changing the tree shape.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.kv_cache import DualPool, PagePool


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0  # lookups with cached_len > 0
    hit_tokens: int = 0  # prompt tokens served from the cache
    prompt_tokens: int = 0  # total prefill tokens seen by lookups
    inserted_pages: int = 0
    evicted_pages: int = 0  # dropped outright
    demoted_pages: int = 0  # device -> host (eviction or acquire relocation)
    promoted_pages: int = 0  # host -> device
    cow_copies: int = 0
    # -- host-tier serving --------------------------------------------------
    # acquires (target="cpu") that served >= 1 host-resident shared page IN
    # PLACE (no promotion, no private copy) ...
    inplace_host_hits: int = 0
    # ... and the hit tokens those (plus host->host COW tails) served without
    # crossing PCIe
    host_served_hit_tokens: int = 0
    # host-resident prefix bytes that DID cross PCIe inside acquire()
    # (promotion relocations + cpu->gpu private/COW copies) — the
    # host-serving gates hold this at ~0 for cpu-placed rows
    host_hit_pcie_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        """Token-level hit rate over all lookups — clamped to [0, 1] and
        NaN-free by construction (retractions keep the counters
        monotone-consistent, see :meth:`PrefixCache.retract_lookup`)."""
        if self.prompt_tokens <= 0:
            return 0.0
        return min(1.0, max(0.0, self.hit_tokens / self.prompt_tokens))


class RadixNode:
    """One path-compressed edge: a run of pages in a single pool.

    ``len(pages) == ceil(len(tokens) / page_size)``; the last page is
    partially valid when ``len(tokens)`` is not page-aligned (leaves only —
    a node with children is always page-aligned)."""

    __slots__ = ("tokens", "pages", "location", "parent", "children",
                 "last_access", "_pinned", "_contrib", "_heap_seq")

    def __init__(self, tokens: List[int], pages: List[int], location: str,
                 parent: Optional["RadixNode"]):
        self.tokens = tokens
        self.pages = pages
        self.location = location  # "gpu" | "cpu"
        self.parent = parent
        # children keyed by their first (up to one page of) tokens
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.last_access = 0
        # incremental evictability bookkeeping (PrefixCache-maintained):
        # number of this node's pages pinned by readers (refcount > 1), the
        # counter bucket the node currently contributes to ("leaf" /
        # "interior" / None when pinned or unregistered), and the sequence
        # number of its newest LRU-heap entry (older entries are stale)
        self._pinned = 0
        self._contrib: Optional[str] = None
        self._heap_seq = -1

    @property
    def npages(self) -> int:
        return len(self.pages)


def _common_tokens(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass
class MatchResult:
    """Outcome of a longest-prefix walk (before any copying/pinning)."""

    cached_len: int = 0
    # full shared pages, in prefix order, with the node that owns each
    shared: List[Tuple[int, RadixNode]] = field(default_factory=list)
    # page to copy-on-write for the final partial-page run (page, node, valid)
    cow: Optional[Tuple[int, RadixNode, int]] = None
    nodes: List[RadixNode] = field(default_factory=list)


class PrefixCache:
    def __init__(self, pool: DualPool, transfer, *,
                 token_granular: bool = True) -> None:
        self.pool = pool
        self.transfer = transfer
        self.page = pool.page_size
        self.token_granular = token_granular
        self.root = RadixNode([], [], "gpu", None)
        self.stats = PrefixCacheStats()
        self._clock = 0
        # tracing (repro_torch.obs): set by the engine when EngineConfig.tracing
        # is on; acquire()/make_room() run on the engine thread only, so
        # the "prefix" track never carries overlapping spans
        self.tracer = None
        # retractable deltas of the most recent acquire() (engine deferral
        # unwinding; see retract_acquire)
        self._last_acquire: Optional[Dict[str, int]] = None
        # -- incremental evictability index (O(log n) PoolView + eviction) --
        # Per-location page counters split by node kind: unpinned LEAF pages
        # are droppable outright; unpinned INTERIOR pages are reclaimable
        # only by demotion (gpu -> host).  A lazy-deletion LRU heap per
        # location orders eviction victims by last_access; entries are
        # invalidated by a per-node sequence number instead of being removed.
        # Pin/unpin events on tree pages reach us through the PagePool
        # refcount listener — engine-side incref/free on shared pages (swap,
        # preempt, request finish) would otherwise be invisible here.
        self._evict_leaf: Dict[str, int] = {"gpu": 0, "cpu": 0}
        self._evict_interior: Dict[str, int] = {"gpu": 0, "cpu": 0}
        self._heaps: Dict[str, List[Tuple[int, int, RadixNode]]] = {
            "gpu": [], "cpu": []}
        self._heap_seq = 0
        self._page_node: Dict[Tuple[str, int], RadixNode] = {}
        pool.device.set_ref_listener(
            lambda p, old, new: self._on_ref("gpu", p, old, new))
        pool.host.set_ref_listener(
            lambda p, old, new: self._on_ref("cpu", p, old, new))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _pool(self, location: str) -> PagePool:
        return self.pool.pool(location)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _unpinned(self, node: RadixNode) -> bool:
        pool = self._pool(node.location)
        return all(pool.refcount(p) == 1 for p in node.pages)

    def _key(self, node: RadixNode) -> Tuple[int, ...]:
        return tuple(node.tokens[: self.page])

    def page_nbytes(self) -> int:
        """PCIe bytes of one page crossing at the host pool's byte width
        (K + V, all layers) — matches the TransferEngine's accounting.
        Public: the serve-time host-serving gate derives its epsilon from
        this same formula so producer and consumer can never drift."""
        host = self.pool.host
        return 2 * host.k[:, :1].numel() * host.k.element_size()

    # ------------------------------------------------------------------
    # incremental evictability index
    # ------------------------------------------------------------------
    # Every mutation of node.pages / node.location goes through
    # _unregister -> mutate -> _register; leaf<->interior transitions call
    # _refresh on the affected node.  The PagePool refcount listener keeps
    # node._pinned current for incref/free calls the cache never issues.
    def _heap_entry_live(self, location: str, seq: int, node: RadixNode) -> bool:
        return (seq == node._heap_seq and node._contrib is not None
                and node.location == location and bool(node.pages))

    def _heap_push(self, node: RadixNode) -> None:
        if node._contrib is None or not node.pages:
            return
        heap = self._heaps[node.location]
        # Touch-pushes leave stale entries behind, and _make_room only pops
        # under memory pressure — a hit-heavy workload with pool headroom
        # would grow the heap forever.  Compact (drop stale, re-heapify)
        # once the heap exceeds 4x an O(1) upper bound on live entries
        # (every live node owns >= 1 mapped page); each compaction shrinks
        # the heap to <= that bound, so the O(heap) sweep amortizes to O(1)
        # per push.
        bound = max(128, 4 * len(self._page_node))
        if len(heap) > bound:
            loc = node.location
            heap[:] = [(la, sq, nd) for la, sq, nd in heap
                       if self._heap_entry_live(loc, sq, nd)]
            heapq.heapify(heap)
        self._heap_seq += 1
        node._heap_seq = self._heap_seq
        heapq.heappush(heap, (node.last_access, self._heap_seq, node))

    def _add_contrib(self, node: RadixNode) -> None:
        if node._pinned == 0 and node.pages:
            kind = "interior" if node.children else "leaf"
            node._contrib = kind
            bucket = self._evict_interior if kind == "interior" else self._evict_leaf
            bucket[node.location] += node.npages
            self._heap_push(node)
        else:
            node._contrib = None

    def _remove_contrib(self, node: RadixNode) -> None:
        if node._contrib == "leaf":
            self._evict_leaf[node.location] -= node.npages
        elif node._contrib == "interior":
            self._evict_interior[node.location] -= node.npages
        node._contrib = None  # stale heap entries invalidate lazily

    def _refresh(self, node: RadixNode) -> None:
        """Recompute a node's counter bucket after a leaf<->interior flip."""
        if node is self.root:
            return
        self._remove_contrib(node)
        self._add_contrib(node)

    def _register(self, node: RadixNode) -> None:
        """Map the node's pages and (re)compute its pin count/contribution."""
        pool = self._pool(node.location)
        for p in node.pages:
            self._page_node[(node.location, p)] = node
        node._pinned = sum(1 for p in node.pages if pool.refcount(p) > 1)
        self._add_contrib(node)

    def _unregister(self, node: RadixNode) -> None:
        self._remove_contrib(node)
        for p in node.pages:
            self._page_node.pop((node.location, p), None)

    def _on_ref(self, location: str, page: int, old: int, new: int) -> None:
        """PagePool refcount-transition hook: track pin (1->2) and unpin
        (2->1) crossings on tree-owned pages, wherever they originate."""
        node = self._page_node.get((location, page))
        if node is None:
            return
        if new == 0:  # defensive: a mapped page must be unmapped before its
            self._page_node.pop((location, page), None)  # tree ref drops
            return
        if old == 1 and new == 2:
            if node._pinned == 0:
                self._remove_contrib(node)
            node._pinned += 1
        elif old == 2 and new == 1:
            node._pinned -= 1
            if node._pinned == 0:
                self._add_contrib(node)

    # ------------------------------------------------------------------
    # match / lookup
    # ------------------------------------------------------------------
    def _find_child(self, cur: RadixNode,
                    rest: Sequence[int]) -> Tuple[Optional[RadixNode], int]:
        """Best-matching child of ``cur`` for ``rest``: the exact
        first-full-page key first (siblings never repeat a full first page,
        so a key hit is the unique longest match), else — token-granular
        mode only — the child sharing the longest common prefix (covers
        partial-tail leaves and divergence inside the first page)."""
        page = self.page
        if len(rest) >= page:
            c = cur.children.get(tuple(rest[:page]))
            if c is not None:
                return c, _common_tokens(c.tokens, rest)
        if not self.token_granular:
            return None, 0
        if not rest:
            return None, 0
        best, bm = None, 0
        first = rest[0]
        for c in cur.children.values():
            # a nonzero common prefix needs equal FIRST tokens — one int
            # compare prunes the O(page) token walk for unrelated siblings
            if not c.tokens or c.tokens[0] != first:
                continue
            m = _common_tokens(c.tokens, rest)
            if m > bm:
                best, bm = c, m
        return best, bm

    def _walk(self, tokens: Sequence[int]) -> MatchResult:
        """Longest prefix at token granularity; never mutates the tree.

        At most ``len(tokens) - 1`` tokens match (at least one token must be
        prefilled to produce first-token logits).
        """
        page = self.page
        res = MatchResult()
        cap = max(len(tokens) - 1, 0)
        cur = self.root
        i = 0  # matched tokens so far (page-aligned while walking)
        while i < len(tokens):
            child, m = self._find_child(cur, tokens[i:])
            if child is None or m <= 0:
                break
            full = (m // page) * page
            res.nodes.append(child)
            for pi in range(full // page):
                res.shared.append((child.pages[pi], child))
            i += full
            if full < len(child.tokens):
                # ended mid-page: divergence inside a page or a leaf's
                # partial tail — served by COW up to the common token
                rem = m - full
                if rem > 0:
                    res.cow = (child.pages[full // page], child, rem)
                break
            cur = child
        # cap: leave >= 1 token to prefill, re-expressing the clipped tail as
        # a COW of the page it lands in
        total = i + (res.cow[2] if res.cow else 0)
        total = min(total, cap)
        f = total // page
        rem = total % page
        if f < len(res.shared):
            cow_page, cow_node = res.shared[f]
            res.shared = res.shared[:f]
            res.cow = (cow_page, cow_node, rem) if rem else None
        elif res.cow is not None:
            cow_page, cow_node, _ = res.cow
            res.cow = (cow_page, cow_node, rem) if rem else None
        res.cached_len = f * page + rem
        return res

    def lookup(self, tokens: Sequence[int]) -> int:
        """Length of the longest cached prefix (no side effects)."""
        return self._walk(tokens).cached_len

    def lookup_ex(self, tokens: Sequence[int]) -> Tuple[int, Optional[str]]:
        """``(cached_len, residency)`` of the longest cached prefix — no side
        effects.  ``residency`` is ``"cpu"`` when the majority of the matched
        tokens live in host-pool nodes (the scheduler then prefers ``cpu``
        placement so the prefix is served in place), ``"gpu"`` otherwise,
        ``None`` on a miss.  Used by :meth:`NeoEngine.submit`."""
        res = self._walk(tokens)
        if res.cached_len == 0:
            return 0, None
        host = sum(self.page for _, n in res.shared if n.location == "cpu")
        if res.cow is not None and res.cow[1].location == "cpu":
            host += res.cow[2]
        return res.cached_len, ("cpu" if 2 * host >= res.cached_len else "gpu")

    # ------------------------------------------------------------------
    # retraction (engine deferral unwinding)
    # ------------------------------------------------------------------
    # All retractions keep the counters MONOTONE-CONSISTENT: hits <= lookups
    # and hit_tokens <= prompt_tokens always hold, so hit_rate stays in
    # [0, 1] and NaN-free under any defer/retry interleaving.
    def retract_hit(self, cached_len: int) -> None:
        """Undo one hit's accounting when the engine discards the acquired
        prefix (cold-prefill fallback) — hit_rate must reflect prefixes that
        were actually consumed."""
        if cached_len > 0:
            self.stats.hits = max(0, self.stats.hits - 1)
            self.stats.hit_tokens = max(0, self.stats.hit_tokens - cached_len)

    def retract_lookup(self, prompt_tokens: int) -> None:
        """Undo one lookup's denominator contribution when the engine defers
        the prefill entirely — the retry re-runs acquire and would otherwise
        double-count the prompt in hit_rate.  Floored at the still-counted
        hit numerators so repeated deferrals can never drive the
        denominators below them."""
        self.stats.lookups = max(self.stats.hits, self.stats.lookups - 1)
        self.stats.prompt_tokens = max(
            self.stats.hit_tokens, self.stats.prompt_tokens - prompt_tokens)

    def retract_acquire(self) -> None:
        """Undo the NON-PERSISTENT stats of the most recent :meth:`acquire`
        when the engine unwinds it (deferral / cold-prefill fallback).

        The hit itself, COW copies, private cross-pool copies and the
        host-serving counters are released with the pages and re-done by the
        retry — leaving them counted would double-count.  Node RELOCATIONS
        (promotions/demotions) persist in the tree, so their page counters
        and PCIe bytes stay: counted once — the retry finds the node already
        in the target pool and moves nothing.
        """
        la, self._last_acquire = self._last_acquire, None
        if not la:
            return
        st = self.stats
        self.retract_hit(la["cached_len"])
        st.cow_copies = max(0, st.cow_copies - la["cow"])
        st.promoted_pages = max(0, st.promoted_pages - la["promoted_copy"])
        st.demoted_pages = max(0, st.demoted_pages - la["demoted_copy"])
        st.inplace_host_hits = max(0, st.inplace_host_hits - la["inplace"])
        st.host_served_hit_tokens = max(
            0, st.host_served_hit_tokens - la["host_served"])
        st.host_hit_pcie_bytes = max(
            0, st.host_hit_pcie_bytes - la["pcie_copy"])

    # ------------------------------------------------------------------
    # acquire (engine thread, at prefill dispatch)
    # ------------------------------------------------------------------
    def acquire(self, tokens: Sequence[int], target: str) -> Tuple[List[int], Optional[int], int]:
        tr = self.tracer
        if tr is None:
            return self._acquire_impl(tokens, target)
        t0 = time.perf_counter()
        shared, cow, cached_len = self._acquire_impl(tokens, target)
        tr.emit("prefix", "acquire", t0, time.perf_counter(),
                {"tokens": len(tokens), "cached_len": cached_len,
                 "cow": cow is not None, "target": target})
        return shared, cow, cached_len

    def _acquire_impl(self, tokens: Sequence[int], target: str) -> Tuple[List[int], Optional[int], int]:
        """Pin the longest cached prefix of ``tokens`` in the ``target`` pool.

        Returns ``(shared_pages, cow_page, cached_len)``: ``shared_pages``
        are incref'd tree pages (released by the request's normal refcounted
        ``free``); ``cow_page`` — present when the match ends mid-page — is a
        private copy valid for the trailing ``cached_len % page_size``
        tokens.  Segments already resident in ``target`` are pinned IN PLACE
        (for ``target="cpu"`` this is the zero-copy host-serving path);
        nodes resident in the other pool are relocated through the
        TransferEngine when unpinned (promotion/demotion), else copied
        privately for this request.
        """
        res = self._walk(tokens)
        self.stats.lookups += 1
        self.stats.prompt_tokens += len(tokens)
        # retractable deltas of THIS acquire (relocations excluded — they
        # persist in the tree; see retract_acquire)
        la = {"cached_len": 0, "cow": 0, "promoted_copy": 0,
              "demoted_copy": 0, "inplace": 0, "host_served": 0,
              "pcie_copy": 0}
        self._last_acquire = la
        if res.cached_len == 0:
            return [], None, 0
        now = self._tick()
        for node in res.nodes:
            node.last_access = now
            self._heap_push(node)  # refresh LRU position (stale entry lingers)

        # PIN FIRST: take the request's reference on every matched page (and
        # the COW source) before any make_room below runs — a pinned page's
        # node can be neither evicted nor relocated, so later segments can't
        # be pulled out from under the in-progress match.
        segments = _segments(res.shared)
        for seg_node, seg_pages in segments:
            self._pool(seg_node.location).incref(seg_pages)
        if res.cow is not None:
            self._pool(res.cow[1].location).incref([res.cow[0]])

        pool_t = self._pool(target)
        page_nb = self.page_nbytes()

        def _fits(n: int) -> bool:
            # best effort: evict/demote, then verify real free pages — the
            # target pool may be held by live requests, in which case the
            # match is truncated to what fits instead of faulting
            if pool_t.free_pages < n:
                self._make_room(target, n)
            return pool_t.free_pages >= n

        out_pages: List[int] = []
        consumed = 0  # segments whose pins have been consumed/transferred
        truncated = False
        host_served = 0  # hit tokens served without crossing PCIe
        inplace_host = 0  # host-pool pages pinned in place (target="cpu")
        for seg_node, seg_pages in segments:
            src_pool = self._pool(seg_node.location)
            if seg_node.location != target:
                src_loc = seg_node.location
                # relocatable: the whole node is matched and carries exactly
                # the tree's reference plus OUR fresh pin on every page
                relocatable = (
                    len(seg_pages) == seg_node.npages
                    and all(src_pool.refcount(p) == 2 for p in seg_node.pages)
                )
                if not _fits(len(seg_pages)):
                    truncated = True
                    break
                if relocatable:
                    # promote/demote the node itself so the tree serves from
                    # the target pool next time; our pin moves to the copies
                    new_pages = self.transfer.copy_pages(
                        seg_node.pages, seg_node.location, target)
                    pool_t.incref(new_pages)  # the request's reference
                    old = seg_node.pages
                    self._unregister(seg_node)
                    seg_node.pages = new_pages
                    seg_node.location = target
                    src_pool.free(old)  # tree's reference
                    src_pool.free(old)  # our pin
                    self._register(seg_node)
                    self._count_move(src_loc, target, len(old))
                    if src_loc == "cpu" and target == "gpu":
                        # a host-resident prefix crossed PCIe (promotion);
                        # persists with the relocation, never retracted
                        self.stats.host_hit_pcie_bytes += page_nb * len(old)
                    pages = new_pages
                else:
                    # pinned by a sibling in the other pool: private copy
                    pages = self.transfer.copy_pages(
                        seg_pages, seg_node.location, target)
                    src_pool.free(seg_pages)  # release our pins on originals
                    self._count_move(src_loc, target, len(pages))
                    if src_loc == "cpu":
                        la["promoted_copy"] += len(pages)
                        if target == "gpu":
                            nb = page_nb * len(pages)
                            self.stats.host_hit_pcie_bytes += nb
                            la["pcie_copy"] += nb
                    else:
                        la["demoted_copy"] += len(pages)
            else:
                pages = seg_pages  # our pin IS the request's reference
                if target == "cpu":
                    # zero-copy host serving: the host tier serves the
                    # prefix in place, at its absolute positions
                    inplace_host += len(seg_pages)
                    host_served += len(seg_pages) * self.page
            consumed += 1
            out_pages.extend(pages)

        cow_page: Optional[int] = None
        rem = 0
        if res.cow is not None and not truncated:
            src_page, cow_node, rem = res.cow
            src_loc = cow_node.location
            if _fits(1):
                cow_page = self.transfer.copy_pages([src_page], src_loc, target)[0]
                self.stats.cow_copies += 1
                la["cow"] += 1
                if src_loc != target:
                    self._count_move(src_loc, target, 1)
                    if src_loc == "cpu":
                        la["promoted_copy"] += 1
                        if target == "gpu":
                            self.stats.host_hit_pcie_bytes += page_nb
                            la["pcie_copy"] += page_nb
                    else:
                        la["demoted_copy"] += 1
                elif src_loc == "cpu":
                    host_served += rem  # host->host COW tail: stays in DRAM
            else:
                rem = 0
        # release pins the match did not consume (truncation) + the COW source
        for seg_node, seg_pages in segments[consumed:]:
            self._pool(seg_node.location).free(seg_pages)
        if res.cow is not None:
            self._pool(res.cow[1].location).free([res.cow[0]])

        cached_len = len(out_pages) * self.page + (rem if cow_page is not None else 0)
        if cached_len > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += cached_len
            la["cached_len"] = cached_len
            if target == "cpu" and inplace_host > 0:
                self.stats.inplace_host_hits += 1
                la["inplace"] = 1
            if target == "cpu" and host_served > 0:
                self.stats.host_served_hit_tokens += host_served
                la["host_served"] = host_served
        return out_pages, cow_page, cached_len

    def _count_move(self, src: str, dst: str, n: int) -> None:
        if src == "gpu" and dst == "cpu":
            self.stats.demoted_pages += n
        elif src == "cpu" and dst == "gpu":
            self.stats.promoted_pages += n

    def _relocate(self, node: RadixNode, target: str) -> Dict[int, int]:
        """Move an unpinned node's pages to ``target``; returns old->new."""
        self._make_room(target, node.npages, exclude=node)
        new_pages = self.transfer.copy_pages(node.pages, node.location, target)
        self._unregister(node)
        self._pool(node.location).free(node.pages)
        mapping = dict(zip(node.pages, new_pages))
        self._count_move(node.location, target, node.npages)
        node.pages = new_pages
        node.location = target
        self._register(node)
        return mapping

    # ------------------------------------------------------------------
    # insert (engine thread, at request finish)
    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int], location: str) -> int:
        """Adopt a finished request's KV pages into the tree.

        ``pages`` must cover ``ceil(len(tokens) / page)`` pages; in
        token-granular mode the last page may be a partial tail (the
        page-aligned mode drops it, the PR-2 behavior).  The tree takes its
        own reference on every adopted page; runs already present are
        skipped, except that a longer copy of an existing partial tail
        UPGRADES it (the tree swaps to the fuller page).  Returns the number
        of newly adopted pages.
        """
        page = self.page
        if not self.token_granular:
            tokens = tokens[: (len(tokens) // page) * page]
        npages = -(-len(tokens) // page)
        assert len(pages) >= npages
        if npages == 0:
            return 0
        now = self._tick()
        cur = self.root
        i = 0  # token index, page-aligned at the top of each iteration
        adopted = 0
        while i < len(tokens):
            rest = tokens[i:]
            child, m = self._find_child(cur, rest)
            if child is None or m <= 0:
                return adopted + self._adopt(
                    cur, list(rest), list(pages[i // page: npages]),
                    location, now)
            if m >= len(rest):
                # fully covered by existing content (any remainder inside a
                # page is servable by COW): nothing to adopt
                child.last_access = now
                self._heap_push(child)
                return adopted
            full_pages = m // page
            aligned = (len(child.tokens) // page) * page
            if m == len(child.tokens):
                if m == aligned:
                    # full page-aligned match: descend
                    child.last_access = now
                    self._heap_push(child)
                    i += m
                    cur = child
                    continue
                # fully matched a partial-tail leaf and the request extends
                # beyond it: upgrade the tail to the request's fuller copy
                # of the same token block (same pool only — page ids are
                # pool-local)
                if child.location != location:
                    # cross-pool: the tail page cannot be swapped, but the
                    # suffix must still be adopted — split the aligned head
                    # off (stays shared) and attach the remainder as a
                    # sibling of the sub-page tail; its first tokens
                    # duplicate the tail, and matching picks the longer node
                    child.last_access = now
                    self._heap_push(child)
                    if full_pages >= 1:
                        child = self._split(child, full_pages)
                        i += full_pages * page
                        cur = child
                    return adopted + self._adopt(
                        cur, list(tokens[i:]),
                        list(pages[i // page: npages]), location, now)
                new_valid = min(len(rest), (full_pages + 1) * page)
                adopted += self._upgrade_tail(
                    child, list(rest[:new_valid]),
                    pages[i // page + full_pages], now)
                if new_valid < (full_pages + 1) * page:
                    return adopted  # still a partial tail; request consumed
                i += new_valid
                cur = child
                continue
            # divergence inside the child
            if full_pages >= 1:
                # shared full pages: split at the page boundary (the
                # sub-page remainder is servable by COW from either half)
                if full_pages * page < len(child.tokens):
                    child = self._split(child, full_pages)
                child.last_access = now
                self._heap_push(child)
                i += full_pages * page
                cur = child
                continue
            # divergence inside the child's first page: no shared full page
            # — adopt the remainder as a sibling (matching scans children at
            # token granularity, so the sub-page overlap still serves hits)
            return adopted + self._adopt(
                cur, list(rest), list(pages[i // page: npages]), location, now)
        return adopted

    def _adopt(self, parent: RadixNode, tokens: List[int], pages: List[int],
               location: str, now: int) -> int:
        """Attach ``tokens``/``pages`` as a new child of ``parent``."""
        self._pool(location).incref(pages)
        node = RadixNode(tokens, pages, location, parent)
        node.last_access = now
        was_leaf = parent is not self.root and not parent.children
        parent.children[self._key(node)] = node
        self._register(node)
        if was_leaf:
            self._refresh(parent)  # leaf -> interior bucket flip
        self.stats.inserted_pages += len(pages)
        return len(pages)

    def _upgrade_tail(self, node: RadixNode, new_tokens: List[int],
                      new_page: int, now: int) -> int:
        """Swap a partial-tail leaf's last page for the inserting request's
        fuller copy of the same token block (both pages hold the block
        starting at the node's aligned length, at the same offsets).
        Readers pinning the old page keep it alive through their own refs;
        the tree's reference moves to the fuller copy."""
        old_tail = node.pages[-1]
        if new_page == old_tail:  # defensive: never tree-double-ref a page
            return 0
        pool = self._pool(node.location)
        old_key = self._key(node)
        self._unregister(node)
        pool.incref([new_page])
        node.pages[-1] = new_page
        node.tokens = new_tokens
        pool.free([old_tail])  # the tree's reference on the shorter copy
        new_key = self._key(node)
        if new_key != old_key and node.parent is not None:
            node.parent.children.pop(old_key, None)
            node.parent.children[new_key] = node
        node.last_access = now
        self._register(node)
        self.stats.inserted_pages += 1
        return 1

    def insert_request(self, req) -> int:
        """Insert a finished request's pages (prompt + emitted tokens).

        Token-granular mode adopts the partial tail page too — the next
        request sharing the prefix at ANY length hits."""
        kv_tokens = req.all_tokens[: req.kv_len]
        npages = -(-len(kv_tokens) // self.page)
        if npages == 0:
            return 0
        return self.insert(kv_tokens, req.pages[:npages], req.location)

    def _split(self, node: RadixNode, at_pages: int) -> RadixNode:
        """Split ``node`` at a page boundary; returns the new parent half.
        The tail half keeps any partial-tail page (it stays a leaf)."""
        page = self.page
        self._unregister(node)
        head = RadixNode(node.tokens[: at_pages * page], node.pages[:at_pages],
                         node.location, node.parent)
        head.last_access = node.last_access
        key = self._key(node)
        node.parent.children[key] = head
        node.tokens = node.tokens[at_pages * page:]
        node.pages = node.pages[at_pages:]
        node.parent = head
        head.children[self._key(node)] = node
        self._register(head)
        self._register(node)
        return head

    # ------------------------------------------------------------------
    # eviction (LRU; demote device pages to host before dropping)
    # ------------------------------------------------------------------
    def evictable_pages(self, location: str) -> int:
        """Pages the cache could free in ``location`` under memory pressure —
        added to the scheduler's PoolView so planning sees reclaimable space.

        O(1) from the incrementally maintained counters: unpinned LEAF pages
        (droppable outright) plus, for the device pool, unpinned INTERIOR
        pages up to the host pool's current free room (interior nodes are
        reclaimable only by demotion — dropping them would orphan children).
        The host-room cap is page-granular where the old full-tree rescan was
        node-granular: marginally more optimistic when a large interior node
        cannot demote whole, which the engine's dispatch-time deferral paths
        already absorb.
        """
        total = self._evict_leaf[location]
        if location == "gpu":
            total += min(self._evict_interior["gpu"], self.pool.host.free_pages)
        return total

    def make_room(self, location: str, n: int) -> None:
        """Ensure ``n`` pages are allocatable in ``location``'s pool, evicting
        LRU cache nodes as needed.  Device evictions demote to the host pool
        through the TransferEngine when it has room; host evictions (and
        device evictions with a full host pool) drop the pages outright."""
        tr = self.tracer
        if tr is None:
            self._make_room(location, n)
            return
        t0 = time.perf_counter()
        self._make_room(location, n)
        tr.emit("prefix", "make_room", t0, time.perf_counter(),
                {"location": location, "need": n})

    def _make_room(self, location: str, n: int, exclude: Optional[RadixNode] = None) -> None:
        # Victims pop off the per-location LRU heap (lazy deletion: an entry
        # is live only while its seq matches the node's newest push and the
        # node still contributes for this location).  Nodes that cannot be
        # reclaimed right now — the excluded node, interior nodes with no
        # host room — are re-pushed after the pass so later calls see them.
        pool = self._pool(location)
        heap = self._heaps[location]
        skipped: List[RadixNode] = []
        while pool.free_pages < n:
            victim: Optional[RadixNode] = None
            while heap:
                _, seq, node = heapq.heappop(heap)
                if not self._heap_entry_live(location, seq, node):
                    continue  # stale entry
                victim = node
                break
            if victim is None:
                break  # nothing reclaimable; let the allocator raise
            if victim is exclude:
                skipped.append(victim)
                continue
            if location == "gpu" and self.pool.host.free_pages >= victim.npages:
                self._relocate(victim, "cpu")  # demote, keep in tree
            elif not victim.children:
                self._drop(victim)
            else:
                skipped.append(victim)  # interior, no host room: not now
        for node in skipped:
            self._heap_push(node)

    def _drop(self, node: RadixNode) -> None:
        assert not node.children
        self._unregister(node)
        self._pool(node.location).free(node.pages)
        self.stats.evicted_pages += node.npages
        parent = node.parent
        if parent is not None:
            parent.children.pop(self._key(node), None)
            if not parent.children:
                self._refresh(parent)  # interior -> leaf bucket flip
        node.pages = []

    # ------------------------------------------------------------------
    # introspection (tests / debugging)
    # ------------------------------------------------------------------
    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def total_pages(self, location: Optional[str] = None) -> int:
        return sum(n.npages for n in self._iter_nodes()
                   if location is None or n.location == location)


def _segments(shared: List[Tuple[int, "RadixNode"]]):
    """Group consecutive (page, node) pairs by owning node, order-preserving."""
    out: List[Tuple[RadixNode, List[int]]] = []
    for page, node in shared:
        if out and out[-1][0] is node:
            out[-1][1].append(page)
        else:
            out.append((node, [page]))
    return out
