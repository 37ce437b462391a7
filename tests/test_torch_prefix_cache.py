"""The port's two-tier radix prefix cache (``repro_torch.core.prefix_cache``)
and the paths that serve its hits, against the JAX package on the same
inputs, at the smoke size (qwen3-0.6b: 4 layers, d_model 128, fp32).

* the scenarios of ``tests/test_prefix_cache.py`` on the port's
  ``DualPool`` / ``TransferEngine`` / ``PrefixCache`` (``device="cpu"``);
* a seeded random sequence of insert / acquire / retract / make_room calls
  through both caches: tree, page ids, locations, refcounts, free lists,
  statistics and copy bytes equal after every call;
* ``prefix_attention`` / ``suffix_attention_merge`` against the JAX
  functions (1e-5 fp32, 2e-2 bf16), ``HostAttention.prefix_partials``
  against the reference's on the same pool arrays (1e-5, bytes read equal),
  and ``DenseLM.prefill_with_prefix`` / ``prefill_with_host_prefix`` against
  the reference model's on bridged weights (logits 1e-4, K/V 1e-5);
* the engine against the reference's, serial and pipelined, perf model
  frozen (``ewma_alpha=0``): tokens, every ``PrefixCacheStats`` field and
  plan-ahead's counters equal, and cache-on tokens equal cache-off tokens;
* tracing on = off with the cache, and the port's trace equal to the
  reference's up to time, prefix-cache spans included.
"""

import collections
import dataclasses
import importlib.util
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.core.host_attention import HostAttention as RefHostAttention  # noqa: E402
from repro.core.kv_cache import DualPool as RefDualPool  # noqa: E402
from repro.core.prefix_cache import PrefixCache as RefPrefixCache  # noqa: E402
from repro.core.transfer import TransferEngine as RefTransferEngine  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.host_attention import HostAttention  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402
from repro_torch.obs import reconcile  # noqa: E402

ARCH = "qwen3-0.6b"
CFG = get_smoke_config(ARCH)
PAGE = CFG.kv_block_size


@pytest.fixture(scope="module")
def weights():
    """(reference config, reference params, port state dict)."""
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(7))
    return cfg_ref, params, params_from_reference(jax.tree.map(np.asarray, params), CFG)


@pytest.fixture
def closing():
    """Register transfer engines and engines; each is closed in teardown."""
    made = []
    yield lambda x: made.append(x) or x
    for x in made:
        x.close()


@pytest.fixture
def make_cache(closing):
    def make(device_pages=32, host_pages=32, token_granular=True):
        pool = DualPool(CFG, device_pages, host_pages, device="cpu")
        tr = closing(TransferEngine(pool))
        return PrefixCache(pool, tr, token_granular=token_granular), pool, tr
    return make


def seed_node(cache, pool, tokens, location="gpu", fill=None):
    """A finished request inserting ``tokens`` (page-aligned), then releasing
    its pages: the tree's reference keeps them."""
    n = len(tokens) // cache.page
    p = pool.pool(location)
    pages = p.alloc(n)
    if fill is not None:
        data = torch.full((p.num_layers, n, cache.page, *p.k.shape[3:]), fill)
        p.put_pages(pages, data, data)
    cache.insert(tokens, pages, location)
    p.free(pages)
    return pages


def copied_bytes(tr):
    return tr.stats.bytes_out + tr.stats.bytes_in


# ---------------------------------------------------------------------------
# the reference's scenarios on the port's cache
# ---------------------------------------------------------------------------


def test_insert_match_page_granularity(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(4 * PAGE))
    seed_node(cache, pool, toks)
    assert cache.num_nodes() == 1 and cache.total_pages("gpu") == 4
    assert cache.lookup(toks + [999]) == 4 * PAGE
    # the cap leaves >= 1 token to prefill: the last token becomes a COW
    assert cache.lookup(toks) == 4 * PAGE - 1
    assert cache.lookup([7777] * (2 * PAGE)) == 0


def test_insert_splits_at_page_boundary(make_cache):
    cache, pool, _ = make_cache()
    a = list(range(4 * PAGE))
    b = a[: 2 * PAGE] + [9000 + i for i in range(2 * PAGE)]
    seed_node(cache, pool, a)
    seed_node(cache, pool, b)
    assert cache.num_nodes() == 3 and cache.total_pages("gpu") == 6
    assert cache.lookup(a + [1]) == cache.lookup(b + [1]) == 4 * PAGE
    before = cache.total_pages()
    seed_node(cache, pool, a)  # a duplicate adopts nothing
    assert cache.total_pages() == before


def test_cow_on_mid_page_divergence(make_cache):
    cache, pool, _ = make_cache()
    a = list(range(2 * PAGE))
    seed_node(cache, pool, a, fill=3.0)
    src = next(cache._iter_nodes()).pages
    b = a[: PAGE + PAGE // 2] + [5555] * PAGE
    shared, cow, clen = cache.acquire(b, "gpu")
    assert clen == PAGE + PAGE // 2
    assert shared == src[:1] and cow is not None and cow not in src
    assert cache.stats.cow_copies == 1
    assert bool((pool.device.k[:, cow] == 3.0).all())  # the copy carries the data
    assert pool.device.refcount(src[1]) == 1
    assert pool.device.refcount(shared[0]) == 2 and pool.device.refcount(cow) == 1


def test_shared_page_survives_sibling_free(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(2 * PAGE))
    seed_node(cache, pool, toks)
    shared, cow, clen = cache.acquire(toks + [1, 2, 3], "gpu")
    assert len(shared) == 2 and cow is None and clen == 2 * PAGE
    free0 = pool.device.free_pages
    pool.device.free(shared)  # a sibling's refcounted release keeps them
    assert pool.device.free_pages == free0
    assert all(pool.device.refcount(p) == 1 for p in shared)
    cache.make_room("gpu", pool.device.num_pages)  # the tree lets go
    assert pool.device.free_pages == free0 + len(shared)


def test_eviction_demotes_before_drop(make_cache):
    cache, pool, _ = make_cache(8, 8)
    seed_node(cache, pool, list(range(2 * PAGE)), fill=1.0)
    seed_node(cache, pool, [10_000 + i for i in range(2 * PAGE)], fill=2.0)
    assert pool.device.free_pages == 4
    cache.make_room("gpu", 6)
    assert cache.stats.demoted_pages == 2 and cache.stats.evicted_pages == 0
    assert cache.total_pages("cpu") == 2 and pool.device.free_pages >= 6
    assert cache.lookup(list(range(2 * PAGE)) + [1]) == 2 * PAGE
    blocker = pool.host.alloc(pool.host.free_pages)  # a full host pool: drop
    cache.make_room("gpu", 8)
    assert cache.stats.evicted_pages == 2 and pool.device.free_pages == 8
    pool.host.free(blocker)


def test_lru_evicts_coldest_first(make_cache):
    cache, pool, _ = make_cache(8, 4)
    a = list(range(2 * PAGE))
    b = [20_000 + i for i in range(2 * PAGE)]
    seed_node(cache, pool, a)
    seed_node(cache, pool, b)
    shared, _, _ = cache.acquire(a + [1], "gpu")  # touch A: B is the victim
    pool.device.free(shared)
    cache.make_room("gpu", 6)
    assert cache.lookup(a + [1]) == 2 * PAGE
    [b_node] = [n for n in cache._iter_nodes() if n.tokens[0] == 20_000]
    assert b_node.location == "cpu"


def test_promotion_through_transfer_engine(make_cache):
    cache, pool, tr = make_cache()
    toks = list(range(2 * PAGE))
    seed_node(cache, pool, toks, location="cpu", fill=4.0)
    bytes_in0 = tr.stats.bytes_in
    shared, cow, clen = cache.acquire(toks + [1], "gpu")
    assert clen == 2 * PAGE and cow is None
    assert cache.total_pages("gpu") == 2 and cache.total_pages("cpu") == 0
    assert cache.stats.promoted_pages == 2
    assert tr.stats.bytes_in - bytes_in0 == 2 * cache.page_nbytes()
    assert bool((pool.device.k[:, shared] == 4.0).all())


def test_acquire_truncates_and_releases_pins_when_target_full(make_cache):
    cache, pool, _ = make_cache(4, 16)
    toks = list(range(3 * PAGE))
    seed_node(cache, pool, toks, location="cpu")
    [node] = list(cache._iter_nodes())
    blocker = pool.device.alloc(pool.device.free_pages)
    shared, cow, clen = cache.acquire(toks + [1], "gpu")
    assert (clen, shared, cow) == (0, [], None)
    assert node.pages and all(pool.host.refcount(p) == 1 for p in node.pages)
    assert cache.lookup(toks + [1]) == 3 * PAGE
    pool.device.free(blocker)


def test_pinned_node_copied_not_relocated(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(2 * PAGE))
    seed_node(cache, pool, toks, location="cpu")
    cache.acquire(toks + [1], "cpu")  # a host reader pins the node
    dev_shared, _, _ = cache.acquire(toks + [2], "gpu")
    assert cache.total_pages("cpu") == 2
    assert all(pool.device.refcount(p) == 1 for p in dev_shared)


def _check_counters(cache, pool):
    """The incremental evictability index against a full-tree rescan."""
    for loc in ("gpu", "cpu"):
        leaf = interior = 0
        for n in cache._iter_nodes():
            if n.location == loc and cache._unpinned(n):
                if n.children:
                    interior += n.npages
                else:
                    leaf += n.npages
        assert cache._evict_leaf[loc] == leaf, loc
        assert cache._evict_interior[loc] == interior, loc
        cap = min(interior, pool.host.free_pages) if loc == "gpu" else 0
        assert cache.evictable_pages(loc) == leaf + cap, loc


def test_evictable_counters_match_rescan_property(make_cache):
    rng = np.random.default_rng(1234)
    cache, pool, _ = make_cache(24, 24)
    bases = [list(range(k, k + 4 * PAGE)) for k in (0, 10_000, 20_000)]
    held = []
    for _ in range(300):
        op = int(rng.integers(0, 5))
        if op == 0:
            base = bases[int(rng.integers(0, len(bases)))]
            n_pages = int(rng.integers(1, 5))
            toks = list(base[: n_pages * PAGE])
            if n_pages > 1 and rng.random() < 0.5:
                tail = int(rng.integers(30_000, 40_000))
                toks = toks[: (n_pages - 1) * PAGE] + [tail + i for i in range(PAGE)]
            loc = "gpu" if rng.random() < 0.7 else "cpu"
            p = pool.pool(loc)
            if p.free_pages >= n_pages:
                pages = p.alloc(n_pages)
                cache.insert(toks, pages, loc)
                p.free(pages)
        elif op == 1:
            base = bases[int(rng.integers(0, len(bases)))]
            cut = int(rng.integers(1, len(base))) if rng.random() < 0.5 else len(base)
            tgt = "gpu" if rng.random() < 0.5 else "cpu"
            shared, cow, _ = cache.acquire(base[:cut] + [77], tgt)
            if shared or cow is not None:
                held.append((tgt, shared + ([cow] if cow is not None else [])))
        elif op == 2 and held:
            tgt, pages = held.pop(int(rng.integers(0, len(held))))
            pool.pool(tgt).free(pages)
        elif op == 3:
            cache.make_room("gpu" if rng.random() < 0.5 else "cpu", int(rng.integers(1, 10)))
        _check_counters(cache, pool)
    for tgt, pages in held:
        pool.pool(tgt).free(pages)
    _check_counters(cache, pool)


def test_make_room_uses_lru_heap_order(make_cache):
    cache, pool, _ = make_cache(12, 2)
    seqs = [[k + i for i in range(2 * PAGE)] for k in (0, 10_000, 20_000)]
    for s in seqs:
        seed_node(cache, pool, s)
    for s in seqs:  # seqs[0] coldest, seqs[2] hottest
        shared, cow, _ = cache.acquire(s + [1], "gpu")
        pool.device.free(shared + ([cow] if cow is not None else []))
    cache.make_room("gpu", pool.device.free_pages + 2)
    by_first = {n.tokens[0]: n.location for n in cache._iter_nodes()}
    assert by_first == {0: "cpu", 10_000: "gpu", 20_000: "gpu"}


def test_token_granular_partial_tail_and_subpage_match(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(2 * PAGE + PAGE // 2))
    pages = pool.device.alloc(3)
    cache.insert(toks, pages, "gpu")
    pool.device.free(pages)
    assert cache.num_nodes() == 1 and cache.total_pages("gpu") == 3
    assert cache.lookup(toks + [999]) == 2 * PAGE + PAGE // 2
    assert cache.lookup(toks[:5] + [7777] * PAGE) == 5
    shared, cow, clen = cache.acquire(toks + [999], "gpu")
    assert clen == 2 * PAGE + PAGE // 2 and len(shared) == 2 and cow is not None


def test_page_aligned_mode_drops_tail(make_cache):
    cache, pool, _ = make_cache(token_granular=False)
    toks = list(range(2 * PAGE + PAGE // 2))
    pages = pool.device.alloc(3)
    cache.insert(toks, pages, "gpu")
    pool.device.free(pages)
    assert cache.total_pages("gpu") == 2
    assert cache.lookup(toks + [999]) == 2 * PAGE
    assert cache.lookup(toks[:5] + [7777] * PAGE) == 0


def test_tail_upgrade_extends_node(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(2 * PAGE + 4))
    pages = pool.device.alloc(3)
    cache.insert(toks, pages, "gpu")
    pool.device.free(pages)
    old_tail = next(cache._iter_nodes()).pages[-1]
    shared, cow, clen = cache.acquire(toks + [1], "gpu")
    assert clen == 2 * PAGE + 4
    longer = list(range(4 * PAGE))
    pg2 = pool.device.alloc(4)
    cache.insert(longer, pg2, "gpu")
    pool.device.free(pg2)
    assert cache.lookup(longer + [1]) == 4 * PAGE
    [n0] = [n for n in cache._iter_nodes() if n.parent is cache.root]
    assert old_tail not in n0.pages
    pool.device.free(shared + ([cow] if cow is not None else []))


def test_inplace_host_acquire_no_pcie(make_cache):
    cache, pool, tr = make_cache()
    toks = list(range(2 * PAGE))
    seed_node(cache, pool, toks, location="cpu", fill=5.0)
    [node] = list(cache._iter_nodes())
    before = copied_bytes(tr)
    shared, cow, clen = cache.acquire(toks + [1], "cpu")
    assert clen == 2 * PAGE and shared == node.pages
    st = cache.stats
    assert (st.inplace_host_hits, st.host_served_hit_tokens, st.host_hit_pcie_bytes,
            st.promoted_pages) == (1, 2 * PAGE, 0, 0)
    assert copied_bytes(tr) == before
    cache.make_room("cpu", pool.host.num_pages)  # pinned: neither moved nor dropped
    assert node.pages == shared and node.location == "cpu"
    dev_shared, _, _ = cache.acquire(toks + [2], "gpu")  # a private copy
    assert node.location == "cpu" and cache.stats.host_hit_pcie_bytes > 0
    pool.device.free(dev_shared)
    pool.host.free(shared)


def test_lookup_ex_reports_residency(make_cache):
    cache, pool, _ = make_cache()
    a = list(range(2 * PAGE))
    b = [90_000 + i for i in range(2 * PAGE)]
    seed_node(cache, pool, a, location="cpu")
    seed_node(cache, pool, b, location="gpu")
    assert cache.lookup_ex(a + [1]) == (2 * PAGE, "cpu")
    assert cache.lookup_ex(b + [1]) == (2 * PAGE, "gpu")
    assert cache.lookup_ex([1, 2, 3]) == (0, None)


def test_retract_acquire_restores_copy_counters(make_cache):
    cache, pool, _ = make_cache()
    toks = list(range(2 * PAGE))
    seed_node(cache, pool, toks, location="cpu")
    [node] = list(cache._iter_nodes())
    pool.host.incref(node.pages)  # a sibling pins the host node: copy, not move
    shared, _, clen = cache.acquire(toks + [1], "gpu")
    assert clen == 2 * PAGE and cache.stats.promoted_pages == 2
    pool.device.free(shared)
    cache.retract_acquire()
    st = cache.stats
    assert (st.promoted_pages, st.hits, st.host_hit_pcie_bytes) == (0, 0, 0)
    shared, _, _ = cache.acquire(toks + [1], "gpu")
    assert cache.stats.promoted_pages == 2 and cache.stats.hits == 1
    pool.device.free(shared)
    pool.host.free(node.pages)


def test_hit_rate_monotone_under_random_defer_retry(make_cache):
    rng = np.random.default_rng(99)
    cache, pool, _ = make_cache(48, 48)
    bases = [list(range(k, k + 3 * PAGE + 5)) for k in (0, 10_000)]
    for b in bases:
        pages = pool.device.alloc(-(-len(b) // PAGE))
        cache.insert(b, pages, "gpu")
        pool.device.free(pages)
    held = []

    def check():
        st = cache.stats
        assert 0.0 <= st.hit_rate <= 1.0 and not np.isnan(st.hit_rate)
        assert st.hits <= st.lookups and st.hit_tokens <= st.prompt_tokens

    for _ in range(300):
        op = int(rng.integers(0, 5))
        b = bases[int(rng.integers(0, len(bases)))]
        cut = int(rng.integers(1, len(b) + 1))
        tgt = "gpu" if rng.random() < 0.7 else "cpu"
        if op in (0, 1):
            shared, cow, _ = cache.acquire(b[:cut] + [7], tgt)
            mine = shared + ([cow] if cow is not None else [])
            if op == 0:
                held.append((tgt, mine))
            else:  # defer: the engine's unwind order
                if mine:
                    pool.pool(tgt).free(mine)
                cache.retract_acquire()
                if rng.random() < 0.8:
                    cache.retract_lookup(cut + 1)
        elif op == 2 and held:
            tgt2, mine = held.pop(int(rng.integers(0, len(held))))
            if mine:
                pool.pool(tgt2).free(mine)
        elif op == 3:  # a stray over-retraction clamps
            cache.retract_lookup(int(rng.integers(1, 50)))
        else:
            cache.make_room(tgt, int(rng.integers(1, 6)))
        check()


def test_cross_pool_partial_tail_does_not_block_adoption(make_cache):
    cache, pool, _ = make_cache()
    short = list(range(PAGE + 4))
    hp = pool.host.alloc(2)
    cache.insert(short, hp, "cpu")
    pool.host.free(hp)
    longer = list(range(3 * PAGE))
    gp = pool.device.alloc(3)
    assert cache.insert(longer, gp, "gpu") == 2
    pool.device.free(gp)
    assert cache.lookup(longer + [1]) == 3 * PAGE
    assert cache.lookup(short + [999]) == PAGE + 4


def test_cache_off_default_unchanged(closing):
    eng = closing(NeoEngine(CFG, EngineConfig(device_pool_pages=16, host_pool_pages=16),
                            device="cpu"))
    assert EngineConfig().prefix_cache is False and eng.prefix_cache is None


def test_shrunken_match_defers_instead_of_token_overrun(closing):
    """A prefill whose match shrank between submit and dispatch is deferred
    when its suffix busts max_batch_tokens, and still finishes."""
    max_bt = 3 * PAGE
    eng = closing(NeoEngine(CFG, EngineConfig(device_pool_pages=64, host_pool_pages=64,
                                              max_batch_tokens=max_bt, prefix_cache=True),
                            device="cpu"))
    rng = np.random.default_rng(5)
    shared = list(map(int, rng.integers(1, 500, size=2 * PAGE)))
    eng.submit(shared, 4)
    eng.run_until_done()
    ra = eng.submit(shared + list(map(int, rng.integers(1, 500, size=PAGE - 4))), 4)
    rb = eng.submit(list(map(int, rng.integers(1, 500, size=PAGE))), 4)
    assert eng.requests[ra].cached_len >= 2 * PAGE - 1
    cache = eng.prefix_cache
    while cache.num_nodes():
        for n in [n for n in cache._iter_nodes() if not n.children]:
            cache._drop(n)
    batches = []
    orig = eng.executor.prefill

    def recording(reqs, to_host, extras_fn=None):
        batches.append(sum(r.suffix_len for r in reqs))
        return orig(reqs, to_host, extras_fn)

    eng.executor.prefill = recording
    eng.run_until_done(200)
    assert batches and max(batches) <= max_bt, batches
    assert eng.requests[ra].state == eng.requests[rb].state == RequestState.FINISHED


def test_defer_after_promoting_acquire_counts_once(closing):
    max_bt = 3 * PAGE
    eng = closing(NeoEngine(CFG, EngineConfig(device_pool_pages=64, host_pool_pages=64,
                                              max_batch_tokens=max_bt, prefix_cache=True,
                                              prefix_host_serving=False), device="cpu"))
    rng = np.random.default_rng(7)
    shared_toks = list(map(int, rng.integers(1, 500, size=2 * PAGE)))
    eng.submit(shared_toks, 4)
    eng.run_until_done()
    cache = eng.prefix_cache
    cache.make_room("gpu", eng.pool.device.num_pages)
    assert cache.total_pages("cpu") > 0 and cache.total_pages("gpu") == 0
    pa = shared_toks + list(map(int, rng.integers(1, 500, size=PAGE - 4)))
    pb = list(map(int, rng.integers(1, 500, size=2 * PAGE)))
    rb = eng.submit(pb, 4)
    ra = eng.submit(pa, 4)
    assert eng.requests[ra].cached_len >= 2 * PAGE - 1
    [node] = [n for n in cache._iter_nodes() if n.parent is cache.root]
    head = cache._split(node, 1)
    cache._drop(next(iter(head.children.values())))
    eng.pool.host.incref(head.pages)  # a sibling pin: the private-copy path
    eng.run_until_done(200)
    assert eng.requests[ra].state == eng.requests[rb].state == RequestState.FINISHED
    st = cache.stats
    assert st.promoted_pages == 1 and st.hits == 1 and st.hit_tokens == PAGE
    assert st.hits <= st.lookups and 0.0 <= st.hit_rate <= 1.0
    eng.pool.host.free(head.pages)


# ---------------------------------------------------------------------------
# the cache against the reference's, call by call
# ---------------------------------------------------------------------------


def _tree(cache):
    """The tree in canonical order: (depth, tokens, pages, location, last
    access) per node."""
    out = []

    def walk(node, depth):
        for key in sorted(node.children):
            c = node.children[key]
            out.append((depth, tuple(c.tokens), tuple(c.pages), c.location, c.last_access))
            walk(c, depth + 1)

    walk(cache.root, 0)
    return out


def _state(cache, pool, tr):
    pools = tuple((list(p._free), list(p._ref)) for p in (pool.device, pool.host))
    return (_tree(cache), pools, dataclasses.asdict(cache.stats),
            cache.evictable_pages("gpu"), cache.evictable_pages("cpu"),
            tr.stats.bytes_out, tr.stats.bytes_in, pool.swap_bytes)


@pytest.mark.parametrize("token_granular", [True, False])
def test_random_calls_match_reference(token_granular, closing):
    """Seeded random insert / acquire / retract / release / make_room calls
    through the port's cache and the reference's: every return value and,
    after every call, the whole state are equal."""
    rng = np.random.default_rng(2024 + token_granular)
    ref_cfg = ref_smoke(ARCH)
    pools = {"port": DualPool(CFG, 20, 20, device="cpu"), "ref": RefDualPool(ref_cfg, 20, 20)}
    trs = {"port": closing(TransferEngine(pools["port"])),
           "ref": closing(RefTransferEngine(pools["ref"]))}
    caches = {"port": PrefixCache(pools["port"], trs["port"], token_granular=token_granular),
              "ref": RefPrefixCache(pools["ref"], trs["ref"], token_granular=token_granular)}
    bases = [list(range(k, k + 3 * PAGE + 5)) for k in (0, 10_000, 20_000)]
    held = []
    for step in range(160):
        op = int(rng.integers(0, 6))
        base = bases[int(rng.integers(0, len(bases)))]
        cut = int(rng.integers(1, len(base) + 1))
        loc = "gpu" if rng.random() < 0.6 else "cpu"
        if op == 0:  # a finished request's pages go into the tree
            toks = base[:cut]
            if rng.random() < 0.4:
                toks = toks + [int(rng.integers(30_000, 40_000)) for _ in range(5)]
            n = -(-len(toks) // PAGE)
            if pools["port"].pool(loc).free_pages < n:
                continue
            got = {}
            for side in ("port", "ref"):
                p = pools[side].pool(loc)
                pages = p.alloc(n)
                got[side] = caches[side].insert(toks, pages, loc)
                p.free(pages)
        elif op in (1, 2):  # acquire, kept (1) or deferred and retracted (2)
            got = {s: caches[s].acquire(base[:cut] + [7], loc) for s in caches}
            shared, cow, _ = got["port"]
            mine = shared + ([cow] if cow is not None else [])
            if op == 1:
                held.append((loc, mine))
            else:
                for side in ("port", "ref"):
                    if mine:
                        pools[side].pool(loc).free(mine)
                    caches[side].retract_acquire()
                    caches[side].retract_lookup(cut + 1)
        elif op == 3 and held:
            tgt, mine = held.pop(int(rng.integers(0, len(held))))
            got = {"port": None, "ref": None}
            for side in ("port", "ref"):
                if mine:
                    pools[side].pool(tgt).free(mine)
        else:
            n = int(rng.integers(1, 8))
            got = {s: caches[s].make_room(loc, n) for s in caches}
        assert got["port"] == got["ref"], (step, op)
        assert _state(caches["port"], pools["port"], trs["port"]) == \
            _state(caches["ref"], pools["ref"], trs["ref"]), (step, op)


def test_copy_pages_and_token_writes_match_reference(closing):
    """copy_pages across every pool pair and write_token_range into both
    pools: the same page ids, bytes and pool contents as the reference."""
    rng = np.random.default_rng(11)
    ref_cfg = ref_smoke(ARCH)
    port, ref = DualPool(CFG, 8, 8, device="cpu"), RefDualPool(ref_cfg, 8, 8)
    tr_p, tr_r = closing(TransferEngine(port)), closing(RefTransferEngine(ref))
    shape = port.device.k.shape
    data = rng.standard_normal((2, 2) + shape).astype(np.float32)
    for i, name in enumerate(("device", "host")):
        pp, rp = port.pool("gpu" if name == "device" else "cpu"), getattr(ref, name)
        pp.k.copy_(torch.from_numpy(data[i, 0]))
        pp.v.copy_(torch.from_numpy(data[i, 1]))
        rp.put_pages(list(range(shape[1])), data[i, 0], data[i, 1])
    for pool in (port.device, port.host, ref.device, ref.host):
        pool.alloc(3)
    for src, dst in (("gpu", "cpu"), ("cpu", "gpu"), ("gpu", "gpu"), ("cpu", "cpu")):
        assert tr_p.copy_pages([0, 2], src, dst) == tr_r.copy_pages([0, 2], src, dst)
    ids, offs = [1, 1, 2], [3, 4, 0]
    toks = rng.standard_normal((2, shape[0], 3) + shape[3:]).astype(np.float32)
    for name in ("device", "host"):
        getattr(port, name).write_token_range(ids, offs, torch.from_numpy(toks[0]),
                                              torch.from_numpy(toks[1]))
        getattr(ref, name).write_token_range(np.asarray(ids), np.asarray(offs), toks[0], toks[1])
    assert (tr_p.stats.bytes_out, tr_p.stats.bytes_in, port.swap_bytes) == \
        (tr_r.stats.bytes_out, tr_r.stats.bytes_in, ref.swap_bytes) != (0, 0, 0)
    for name in ("device", "host"):
        for t in ("k", "v"):
            np.testing.assert_array_equal(getattr(getattr(port, name), t).numpy(),
                                          np.asarray(getattr(getattr(ref, name), t)))


# ---------------------------------------------------------------------------
# the pieces that serve a hit, against the JAX functions
# ---------------------------------------------------------------------------


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _attn_inputs(rng, B=3, S=9, T=37, H=4, KV=2, hd=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, S, H, hd), k_pre=f(B, T, KV, hd), v_pre=f(B, T, KV, hd),
                prefix_lens=np.asarray([T, 0, 20], np.int32)[:B],
                k_new=f(B, S, KV, hd), v_new=f(B, S, KV, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["prefix_attention", "suffix_attention_merge"])
def test_suffix_attention_matches_jax(fn, dtype):
    x = _attn_inputs(np.random.default_rng(3))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    act = ("q", "k_pre", "v_pre", "k_new", "v_new")
    t = {k: torch.from_numpy(v).to(tdt) if k in act else torch.from_numpy(v)
         for k, v in x.items()}
    j = {k: jnp.asarray(v, jdt) if k in act else jnp.asarray(v) for k, v in x.items()}
    if fn == "prefix_attention":
        got = attn.prefix_attention(**t)
        want = ref_attn.prefix_attention(**j)
        assert got.dtype == tdt
    else:
        # host partials over the prefix, as HostAttention computes them
        m = np.full(x["q"].shape[:3], -1e30, np.float32)
        l_ = np.zeros_like(m)
        acc = np.zeros_like(x["q"])
        qpk = x["q"].shape[2] // x["k_pre"].shape[2]
        for b, T in enumerate(x["prefix_lens"]):
            if T:
                k = np.repeat(x["k_pre"][b, :T], qpk, axis=1)
                v = np.repeat(x["v_pre"][b, :T], qpk, axis=1)
                s = np.einsum("shd,thd->sht", x["q"][b], k) / np.sqrt(x["q"].shape[-1])
                m[b] = s.max(-1)
                e = np.exp(s - m[b][..., None])
                l_[b], acc[b] = e.sum(-1), np.einsum("sht,thd->shd", e, v)
        got = attn.suffix_attention_merge(t["q"], t["k_new"], t["v_new"], torch.from_numpy(acc),
                                          torch.from_numpy(l_), torch.from_numpy(m))
        want = ref_attn.suffix_attention_merge(j["q"], j["k_new"], j["v_new"], jnp.asarray(acc),
                                               jnp.asarray(l_), jnp.asarray(m))
        assert got.dtype == torch.float32
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("pool_dtype", [np.float32, np.float16])
def test_prefix_partials_match_reference(pool_dtype):
    rng = np.random.default_rng(4)
    L, P, KV, hd = 2, 12, CFG.num_kv_heads, CFG.head_dim
    pk = rng.standard_normal((L, P, PAGE, KV, hd)).astype(pool_dtype)
    pv = rng.standard_normal((L, P, PAGE, KV, hd)).astype(pool_dtype)
    q = rng.standard_normal((3, 7, CFG.num_heads, hd)).astype(np.float32)
    tables = np.asarray([[5, 2, 9], [0, 0, 0], [11, 3, 0]], np.int32)
    lens = np.asarray([2 * PAGE + 3, 0, PAGE + 1], np.int32)
    port, ref = HostAttention(CFG, pk, pv), RefHostAttention(ref_smoke(ARCH), pk, pv)
    for layer in range(L):
        got = port.prefix_partials(layer, q, tables, lens)
        want = ref.prefix_partials(layer, q, tables, lens)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        assert (got[2][1] == -1e30).all()  # no prefix: the merge discards the row
    assert port.prefix_bytes_read == ref.prefix_bytes_read > 0
    assert port.prefix_busy_time > 0 and port.busy_time == 0.0


def _prefix_case(rng, params, cfg_ref):
    """Prompts of 3 rows, a cold reference prefill of each full prompt, and
    the prefix K/V of its first prefix_lens tokens, padded to T."""
    lens = np.asarray([23, 9, 16], np.int32)
    suffix = np.asarray([5, 11, 1], np.int32)
    S, T = int(suffix.max()), int(lens.max())
    full = rng.integers(1, 500, size=(3, T + S)).astype(np.int32)
    model = ref_get_model(cfg_ref)
    _, cache = model.prefill(params, jnp.asarray(full))
    kc, vc = np.asarray(cache["k"]), np.asarray(cache["v"])  # [L, B, T+S, KV, hd]
    pre_k = np.zeros(kc.shape[:2] + (T,) + kc.shape[3:], np.float32)
    pre_v = np.zeros_like(pre_k)
    tokens = np.zeros((3, S), np.int32)
    for b in range(3):
        pre_k[:, b, : lens[b]] = kc[:, b, : lens[b]]
        pre_v[:, b, : lens[b]] = vc[:, b, : lens[b]]
        tokens[b, : suffix[b]] = full[b, lens[b]: lens[b] + suffix[b]]
    return model, tokens, suffix, lens, pre_k, pre_v


def _compare_prefill(got, want):
    logits, k, v = got
    _close(logits, want[0], 1e-4)
    _close(k, want[1], 1e-5)
    _close(v, want[2], 1e-5)


def test_prefill_with_prefix_matches_reference(weights):
    cfg_ref, params, state = weights
    model, tokens, suffix, lens, pre_k, pre_v = _prefix_case(np.random.default_rng(8), params,
                                                             cfg_ref)
    want = model.prefill_with_prefix(params, jnp.asarray(tokens), jnp.asarray(pre_k),
                                     jnp.asarray(pre_v), jnp.asarray(lens),
                                     true_lens=jnp.asarray(suffix))
    port = NeoEngine(CFG, EngineConfig(device_pool_pages=4, host_pool_pages=4), params=state,
                     device="cpu")
    port.close()
    got = port.model.prefill_with_prefix(
        torch.from_numpy(tokens).long(), torch.from_numpy(pre_k), torch.from_numpy(pre_v),
        torch.from_numpy(lens), true_lens=torch.from_numpy(suffix))
    _compare_prefill(got, want)


def test_prefill_with_host_prefix_matches_reference(weights):
    """The host variant: the prefix lies in a host pool and each layer's
    partials come from a HostAttention over it (the reference's through its
    ordered io_callback under jit, the port's through the plain callable)."""
    cfg_ref, params, state = weights
    model, tokens, suffix, lens, pre_k, pre_v = _prefix_case(np.random.default_rng(9), params,
                                                             cfg_ref)
    L, B, T, KV, hd = pre_k.shape
    npg = -(-T // PAGE)
    pool_k = np.zeros((L, B * npg + 1, PAGE, KV, hd), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = np.zeros((B, npg), np.int32)
    for b in range(B):  # each row its own pages, in reverse order
        tables[b] = [1 + b * npg + (npg - 1 - j) for j in range(npg)]
        pad = np.zeros((L, npg * PAGE - T, KV, hd), np.float32)
        kb, vb = np.concatenate([pre_k[:, b], pad], 1), np.concatenate([pre_v[:, b], pad], 1)
        pool_k[:, tables[b]] = kb.reshape(L, npg, PAGE, KV, hd)
        pool_v[:, tables[b]] = vb.reshape(L, npg, PAGE, KV, hd)
    ref_host = RefHostAttention(cfg_ref, pool_k, pool_v)
    port_host = HostAttention(CFG, pool_k, pool_v)

    def ref_cb(layer, q):
        return ref_host.prefix_partials(int(layer), np.asarray(q), tables, lens)

    fn = jax.jit(lambda p, t, pl, tl: model.prefill_with_host_prefix(
        p, t, pl, prefix_cb=ref_cb, true_lens=tl))
    want = fn(params, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(suffix))
    calls = []

    def port_cb(layer, q):
        calls.append(layer)
        return port_host.prefix_partials(layer, q.float().numpy(), tables, lens)

    port = NeoEngine(CFG, EngineConfig(device_pool_pages=4, host_pool_pages=4), params=state,
                     device="cpu")
    port.close()
    got = port.model.prefill_with_host_prefix(
        torch.from_numpy(tokens).long(), torch.from_numpy(lens), prefix_cb=port_cb,
        true_lens=torch.from_numpy(suffix))
    assert calls == list(range(CFG.num_layers))  # once per layer, in order
    _compare_prefill(got, want)
    assert port_host.prefix_bytes_read == ref_host.prefix_bytes_read


def test_mixed_hit_prefill_does_not_wait_for_busy_host_lanes(closing):
    """A prefill call with both device and host prefix hits runs its host
    leg on a thread of its own, not a host lane's: with every host-lane
    thread held busy it returns before they are released, with the logits
    of the same call on idle lanes."""
    eng = closing(NeoEngine(CFG, EngineConfig(device_pool_pages=32, host_pool_pages=32,
                                              prefix_cache=True), device="cpu"))
    ex, rng = eng.executor, np.random.default_rng(3)
    rows, flags = [], []
    for host in (False, True):
        pool = eng.pool.pool("cpu" if host else "gpu")
        for n, cached in ((40, 21), (33, 16)):
            prompt = rng.integers(1, 500, size=n).tolist()
            _, cache = eng.model.prefill(torch.tensor([prompt]), impl="plain")
            r = Request(rid=len(rows), prompt=prompt, max_new_tokens=1)
            r.state, r.location = RequestState.RUNNING, "cpu" if host else "gpu"
            r.pages, r.cached_len = pool.alloc(-(-n // PAGE)), cached
            pool.write_token_range([r.pages[p // PAGE] for p in range(cached)],
                                   [p % PAGE for p in range(cached)],
                                   cache["k"][:, 0, :cached], cache["v"][:, 0, :cached])
            rows.append(r)
            flags.append(host)
    idle = ex.prefill(rows, flags)
    release = threading.Event()
    held = [ex._lane_pool.submit(release.wait) for _ in range(ex.host_lanes)]
    timer = threading.Timer(60.0, release.set)  # the old queueing would wait for this
    timer.start()
    try:
        busy = ex.prefill(rows, flags)
        assert not release.is_set(), "the host leg waited for the host lanes"
    finally:
        release.set()
        timer.cancel()
    for f in held:
        f.result(timeout=60.0)
    np.testing.assert_array_equal(busy, idle)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_prefix_phase_schedule(monkeypatch):
    """The schedule of ``chip_smoke.py``'s prefix phase, runs (a) cache off
    and (b) cache on, planned as on the card: the engine's perf model and
    scheduler see full-width qwen3-0.6b while the model computes at the
    smoke size on the CPU.  With the perf model frozen, no eos and prompts
    without outputs, the schedule does not depend on the tokens, so these
    are the counts the card's run shows: prefill tokens, the residency of
    every prefilled row's prefix, the prefix-cache counters and the
    executor calls (K2 launches = 28 x prefill calls with a cold row, K1
    launches = 28 x batch-0 passes)."""
    cs = _load_chip_smoke()
    full = get_config(ARCH)
    perf_for_arch, scheduler = engine_mod.PerfModel.for_arch, engine_mod.NeoScheduler
    monkeypatch.setattr(engine_mod.PerfModel, "for_arch",
                        lambda cfg, *a, **k: perf_for_arch(full, *a, **k))
    monkeypatch.setattr(engine_mod, "NeoScheduler", lambda cfg, *a, **k: scheduler(full, *a, **k))
    got = {}
    for cache in (False, True):
        eng, _, _, calls, residency = cs.prefix_run(CFG, "cpu", cache=cache)
        got[cache] = {"prefill_tokens": eng.stats.prefill_tokens, "calls": calls,
                      "residency": dict(collections.Counter(residency.values()))}
        if cache:
            st = eng.prefix_cache.stats
            got[cache]["stats"] = {"cow_copies": st.cow_copies,
                                   "demoted_pages": st.demoted_pages,
                                   "promoted_pages": st.promoted_pages,
                                   "inplace_host_hits": st.inplace_host_hits}
    assert got[False] == {"prefill_tokens": 7105, "residency": {"cold": 12},
                          "calls": {"decode": 0, "decode_batch0": 59, "prefill": 9,
                                    "prefill_with_cold_row": 9}}
    assert got[True] == {"prefill_tokens": 2002,
                         "residency": {"cold": 3, "device hit": 7, "in-place host hit": 1,
                                       "demoted with its row": 1},
                         "calls": {"decode": 0, "decode_batch0": 61, "prefill": 9,
                                   "prefill_with_cold_row": 1},
                         "stats": {"cow_copies": 9, "demoted_pages": 93, "promoted_pages": 21,
                                   "inplace_host_hits": 2}}


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------


def _cold_prompts():
    """test_cached_prefill_matches_cold's prompts: a 40-token shared head,
    then an exact repeat (a full-prompt hit with COW)."""
    rng = np.random.default_rng(0)
    shared = list(map(int, rng.integers(1, 500, size=40)))
    prompts = [shared + list(map(int, rng.integers(1, 500, size=12))) for _ in range(3)]
    return prompts + [list(prompts[-1])]


def _granular_prompts():
    """test_token_granular_bitwise_identity_property's prompts: sharing a
    prefix at non-page-aligned lengths."""
    rng = np.random.default_rng(3)
    base = list(map(int, rng.integers(1, 500, size=2 * PAGE + 5)))
    prompts = [base + list(map(int, rng.integers(1, 500, size=int(rng.integers(1, 12)))))
               for _ in range(3)]
    return prompts + [base[: PAGE + 3] + list(map(int, rng.integers(1, 500, size=7)))]


# name: (engine options, prompts, outputs, sequential submission)
SCENARIOS = {
    "cached-vs-cold": (dict(device_pool_pages=64, host_pool_pages=128, max_batch_tokens=512,
                            policy="neo"), _cold_prompts, 6, True),
    "gpu-roomy": (dict(device_pool_pages=64, host_pool_pages=128, max_batch_tokens=256,
                       policy="neo"), _granular_prompts, 6, False),
    "host-forced": (dict(device_pool_pages=6, host_pool_pages=128, max_batch_tokens=256,
                         policy="neo"), _granular_prompts, 6, False),
    "preempting": (dict(device_pool_pages=8, host_pool_pages=10, max_batch_tokens=256,
                        policy="fastdecode", starvation_limit=2), _granular_prompts, 16, False),
}


def _drive(eng, prompts, n_out, sequential):
    """Sequential: each prompt runs to its end before the next (earlier ones
    seed the tree); else the first seeds it and the rest run together."""
    out = {}
    groups = [[p] for p in prompts] if sequential else [prompts[:1], prompts[1:]]
    for group in groups:
        for p in group:
            eng.submit(p, n_out)
        out.update(eng.run_until_done(500))
    return out


def _build(side, weights, **kw):
    cfg_ref, params, state = weights
    kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, **kw)
    if side == "ref":
        return RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
    return NeoEngine(CFG, EngineConfig(**kw), params=state, device="cpu")


def _preempts(eng):
    return sum(int(s.split("preempt=")[1].split()[0]) for s in eng.stats.plans)


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_reference(scenario, pipeline, weights, closing):
    opts, prompts, n_out, sequential = SCENARIOS[scenario]
    prompts = prompts()
    runs = {}
    for side, cache_on in (("ref", True), ("port", True), ("port", False)):
        eng = closing(_build(side, weights, pipeline=pipeline, prefix_cache=cache_on, **opts))
        toks = _drive(eng, prompts, n_out, sequential)
        assert all(r.state.name == "FINISHED" for r in eng.requests.values())
        runs[side, cache_on] = (eng, toks)
    (ref, ref_toks), (port, port_toks) = runs["ref", True], runs["port", True]
    assert port_toks == ref_toks, scenario
    assert runs["port", False][1] == port_toks, f"{scenario}: cache on changed the tokens"
    assert dataclasses.asdict(port.prefix_cache.stats) == \
        dataclasses.asdict(ref.prefix_cache.stats)
    assert port.prefix_cache.stats.hits >= 1 and port.prefix_cache.stats.hit_tokens > 0
    ps, rs = port.stats, ref.stats
    assert (ps.prefill_tokens, ps.planahead_hits, ps.planahead_replans,
            ps.planahead_skipped, ps.plans) == \
        (rs.prefill_tokens, rs.planahead_hits, rs.planahead_replans,
         rs.planahead_skipped, rs.plans)
    assert ps.prefill_tokens < runs["port", False][0].stats.prefill_tokens
    if scenario == "preempting":
        # recompute preemption fired mid-stream (in the cache-off run, as in
        # the reference's test), and host rows were served in place
        assert _preempts(port) + _preempts(runs["port", False][0]) > 0
        assert port.prefix_cache.stats.inplace_host_hits > 0
    if scenario == "host-forced":
        assert port.prefix_cache.stats.demoted_pages > 0


# ---------------------------------------------------------------------------
# tracing with the cache
# ---------------------------------------------------------------------------


TIME_ARGS = ("dur", "host_busy")


def _shape(events):
    out = collections.defaultdict(collections.Counter)
    for e in events:
        args = tuple(sorted((k, "<time>" if k in TIME_ARGS else v)
                            for k, v in (e.args or {}).items()))
        out[e.track][(e.ph, e.name, e.rid, args)] += 1
    return dict(out)


def test_tracing_bitwise_identity_prefix_cache(weights, closing):
    """Tracing on = off with the cache (the reference's test), reconcile()
    holds, and the port's trace equals the reference's up to time, with the
    prefix, copy-sync and host-prefix tracks."""
    opts, prompts, n_out, _ = SCENARIOS["preempting"]
    prompts = prompts()
    runs = {}
    for side, tracing in (("port", False), ("port", True), ("ref", True)):
        eng = closing(_build(side, weights, pipeline=True, prefix_cache=True, tracing=tracing,
                             **opts))
        runs[side, tracing] = (eng, _drive(eng, prompts, n_out, False))
    port, toks = runs["port", True]
    assert toks == runs["port", False][1] == runs["ref", True][1]
    assert port.prefix_cache.stats.hits > 0 and port.tracer.dropped == 0
    rep = reconcile(port.tracer, port.stats)
    assert rep.ok, rep.failed()
    ref_shape = _shape(runs["ref", True][0].tracer.events())
    port_shape = _shape(port.tracer.events())
    assert {"prefix", "copy-sync", "hostattn-prefix"} <= set(port_shape)
    assert sorted(port_shape) == sorted(ref_shape)
    for track in ref_shape:
        assert port_shape[track] == ref_shape[track], track
