"""The prefix cache's paths on the card: a hit's suffix prefill over a
prefix gathered from the device pool and over a prefix the host serves in
place, at full width against the plain cold prefill; ``copy_pages`` ordered
against the compute stream and against swaps in flight; and the record of
bf16 tokens with the cache on against the cache off, with the fp16 host pool
and with a host pool holding bf16 values.  These tests carry the ``cuda``
marker and skip without a card; the CPU paths are held to the JAX reference
in ``test_torch_prefix_cache.py``.  No JAX here: the card's machine has
none.  Run with ``-s`` to see the record."""

import collections
import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.kv_cache import DualPool, PagePool  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import run_conversations  # noqa: E402
from repro_torch.serving.traces import multiturn_trace  # noqa: E402

WAIT = 60.0
TOL = 2e-3  # fp32, the kernels' tolerance in chip_smoke.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's pools, streams and GEMMs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, what):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    assert bool((err <= TOL + TOL * want.abs()).all()), f"{what}: max_abs_err {float(err.max())}"
    return float(err.max())


@pytest.mark.cuda
def test_card_cached_prefill_paths_match_plain_prefill(cuda):
    """Full-width qwen3-0.6b in fp32: six rows in one prefill call, three
    prompts whose first ``cached`` tokens (mid-page, mid-page, page-aligned)
    lie in the device pool (the gather path) and the same three with the
    prefix in the host pool (the in-place host path, on its lane thread
    beside the gather).  Each row's first-token logits and the suffix K/V it
    writes into its pool equal the plain cold prefill of the whole prompt
    (plain attention, no kernel), whose prefix K/V seeded the pools.  The
    same call with every host-lane thread held busy returns before they are
    released; its times are printed."""
    cfg = get_config("qwen3-0.6b").replace(param_dtype="float32", activation_dtype="float32")
    eng = NeoEngine(cfg, EngineConfig(device_pool_pages=128, host_pool_pages=256,
                                      prefix_cache=True), device=cuda)
    try:
        page, model = cfg.kv_block_size, eng.model
        rng = np.random.default_rng(0)
        cases = [(300, 257), (517, 496), (64, 16)]  # (prompt length, cached tokens)
        rows, want, flags = [], [], []
        for host in (False, True):
            pool = eng.pool.pool("cpu" if host else "gpu")
            for n, cached in cases:
                prompt = rng.integers(1, 500, size=n).tolist()
                logits, cache = model.prefill(torch.tensor([prompt]), impl="plain")
                r = Request(rid=len(rows), prompt=prompt, max_new_tokens=1)
                r.state, r.location = RequestState.RUNNING, "cpu" if host else "gpu"
                r.pages = pool.alloc(-(-n // page))
                r.cached_len = cached
                pos = range(cached)
                pool.write_token_range([r.pages[p // page] for p in pos],
                                       [p % page for p in pos],
                                       cache["k"][:, 0, :cached], cache["v"][:, 0, :cached])
                rows.append(r)
                want.append((logits[0], cache["k"][:, 0, cached:n], cache["v"][:, 0, cached:n]))
                flags.append(host)
        calls = collections.Counter()
        for name in ("_prefill_cached_gather", "_prefill_cached_host", "_prefill_cold"):
            fn = getattr(eng.executor, name)
            setattr(eng.executor, name,
                    lambda *a, _fn=fn, _n=name, **k: calls.update([_n]) or _fn(*a, **k))
        got = eng.executor.prefill(rows, flags)
        torch.cuda.synchronize()
        assert calls == {"_prefill_cached_gather": 1, "_prefill_cached_host": 1}
        errs = []
        for r, host, (lg, k, v), g in zip(rows, flags, want, got):
            pool = eng.pool.pool("cpu" if host else "gpu")
            idx = [r.pages[p // page] for p in range(r.cached_len, r.prompt_len)]
            off = [p % page for p in range(r.cached_len, r.prompt_len)]
            ids = torch.tensor(idx, device=pool.k.device)
            offs = torch.tensor(off, device=pool.k.device)
            errs.append(_close(torch.from_numpy(g), lg, f"rid {r.rid} logits"))
            errs.append(_close(pool.k[:, ids, offs], k, f"rid {r.rid} suffix K"))
            errs.append(_close(pool.v[:, ids, offs], v, f"rid {r.rid} suffix V"))
        assert eng.host_attn.prefix_bytes_read > 0
        print(json.dumps({"cached_prefill_vs_plain": {"max_abs_err": max(errs),
                                                       "rows": len(rows)}}))
        print(json.dumps({"mixed_hit_prefill_ms": _mixed_prefill_times(eng, rows, flags)}))
    finally:
        eng.close()


def _mixed_prefill_times(eng, rows, flags):
    """The mixed prefill's wall time (ms) with the host lanes idle, with
    every lane thread held busy (it must not wait for them: its host leg has
    a thread of its own), and beside one host-lane decode per lane of a
    512-token host row."""
    ex, page = eng.executor, eng.cfg.kv_block_size

    def timed():
        t0 = time.perf_counter()
        ex.prefill(rows, flags)
        return (time.perf_counter() - t0) * 1e3

    idle = timed()
    release = threading.Event()
    held = [ex._lane_pool.submit(release.wait) for _ in range(ex.host_lanes)]
    timer = threading.Timer(WAIT, release.set)
    timer.start()
    try:
        busy = timed()
        assert not release.is_set(), "the host leg waited for the host lanes"
    finally:
        release.set()
        timer.cancel()
    for f in held:
        f.result(timeout=WAIT)
    lane_rows = []
    for i in range(ex.host_lanes):
        r = Request(rid=100 + i, prompt=list(range(1, 513)), max_new_tokens=2)
        r.state, r.location = RequestState.RUNNING, "cpu"
        r.pages = eng.pool.host.alloc(-(-513 // page))
        lane_rows.append(r)
    lanes = [ex.submit_host_lane([r], lane=i + 1) for i, r in enumerate(lane_rows)]
    beside = timed()
    for f in lanes:
        f.result(timeout=WAIT)
    return {"lanes_idle": idle, "lanes_held": busy, "beside_lane_decodes": beside,
            "host_lanes": ex.host_lanes}


@pytest.mark.cuda
def test_card_copy_pages_orders_against_swaps(cuda):
    """On the card, bf16 device pool and fp16 host pool: copy_pages from the
    device reads a page after the write queued before it on the compute
    stream; a swap-out's freed device pages, taken at once by a copy_pages
    from the host, are written only after the swap-out's gather read them,
    so the swapped request's host copy holds its own data and the new page
    the copied data; and the copies come back equal to their sources."""
    cfg = get_smoke_config("qwen3-0.6b").replace(name="bf16-smoke", param_dtype="bfloat16",
                                                 activation_dtype="bfloat16")
    pool = DualPool(cfg, 8, 8, device=cuda)
    compute = torch.cuda.Stream(cuda)
    te = TransferEngine(pool, compute_stream=compute)
    L, page = cfg.num_attention_layers, cfg.kv_block_size
    shape = (L, 2, page, cfg.num_kv_heads, cfg.head_dim)
    try:
        # a write queued on the compute stream, then copied to the host
        src = pool.device.alloc(1)
        data = torch.randn((L, 1, *shape[2:]), device=cuda)
        with torch.cuda.stream(compute):
            torch.cuda._sleep(50_000_000)  # keep the stream busy past the call
            pool.device.put_pages(src, data, data)
        [dst] = te.copy_pages(src, "gpu", "cpu")
        k_h, _ = pool.host.read_pages([dst])
        torch.testing.assert_close(k_h, data.bfloat16().half().cpu(), rtol=0, atol=0)

        # a swap-out in flight whose freed pages a host -> device copy takes
        req = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4)
        req.state, req.location = RequestState.RUNNING, "gpu"
        req.pages = pool.device.alloc(2)
        mine = torch.randn(shape, device=cuda)
        other = torch.randn((L, 2, *shape[2:]))
        host_src = pool.host.alloc(2)
        pool.host.put_pages(host_src, other, other)
        blocker = pool.device.alloc(pool.device.free_pages)  # only req's pages come free
        with torch.cuda.stream(compute):
            torch.cuda._sleep(50_000_000)
            pool.device.put_pages(req.pages, mine, mine)
            old = list(req.pages)
            h = te.swap_out(req)
        new = te.copy_pages(host_src, "cpu", "gpu")
        assert sorted(new) == sorted(old)  # the swap's freed pages, reused at once
        te.join([h], timeout=WAIT)
        k_swapped, _ = pool.host.read_pages(req.pages)
        torch.testing.assert_close(k_swapped, mine.bfloat16().half().cpu(), rtol=0, atol=0)
        k_new, _ = pool.device.read_pages(new)
        torch.testing.assert_close(k_new.cpu(), other.half().bfloat16(), rtol=0, atol=0)
        # device -> device and host -> host copies
        pool.device.free(blocker)
        [dd] = te.copy_pages(new[:1], "gpu", "gpu")
        [hh] = te.copy_pages(host_src[:1], "cpu", "cpu")
        assert torch.equal(pool.device.read_pages([dd])[0], pool.device.read_pages(new[:1])[0])
        assert torch.equal(pool.host.read_pages([hh])[0], pool.host.read_pages(host_src[:1])[0])
        assert te.stats.bytes_out > 0 and te.stats.bytes_in > 0
    finally:
        te.close()


# the prefix phase of chip_smoke.py: the reference benchmark's prefill-heavy
# multiturn shape (benchmarks/prefix_cache.py:39-45), 12 requests
SHAPE = dict(system_len=384, context_len=96, user_len_median=64, output_median=10, max_output=16)


def _conversations(monkeypatch, *, cache: bool, host_bf16: bool = False):
    """Full-width bf16 qwen3-0.6b, pipelined, perf model frozen, pools
    80/512, through ``run_conversations``; with ``host_bf16`` the host pool
    holds bf16 values exactly, in float32 storage (numpy has no bfloat16).
    Returns (tokens by prompt, residency of each row's prefix by prompt,
    prefix-cache stats)."""
    init_pool = PagePool.__init__

    def f32_host_pool(self, cfg, num_pages, *, backend, device, num_layers=None):
        init_pool(self, cfg, num_pages, backend=backend, device=device, num_layers=num_layers)
        if backend == "host":
            self.dtype = torch.float32
            self.k = torch.zeros(self.k.shape, dtype=torch.float32, pin_memory=self.pinned)
            self.v = torch.zeros(self.v.shape, dtype=torch.float32, pin_memory=self.pinned)

    cfg = get_config("qwen3-0.6b")
    with monkeypatch.context() as mp:
        if host_bf16:
            mp.setattr(PagePool, "__init__", f32_host_pool)
        eng = NeoEngine(cfg, EngineConfig(device_pool_pages=80, host_pool_pages=512,
                                          policy="neo", ewma_alpha=0.0, seed=0,
                                          prefix_cache=cache), device="cuda")
    residency = {}
    prefill = eng.executor.prefill

    def logged(reqs, to_host):
        for r, host in zip(reqs, to_host):
            residency[tuple(r.prompt)] = ("cold" if r.cached_len == 0 else
                                          ("host" if host else "device")
                                          + f", prefix on the {r.prefix_loc} at submit")
        return prefill(reqs, to_host)

    eng.executor.prefill = logged
    try:
        trace = multiturn_trace(12, rate=1e9, seed=0, turns=4, vocab=500, **SHAPE)
        m = run_conversations(eng, trace)
    finally:
        eng.close()
    assert len(m.finished) == 12
    host = eng.pool.host
    assert host.dtype == (torch.float32 if host_bf16 else torch.float16)
    if host_bf16:  # the values a bf16 pool would hold, exactly
        for t in (host.k, host.v):
            assert torch.equal(t, t.bfloat16().float())
    tokens = {tuple(r.prompt): list(r.out_tokens) for r in eng.requests.values()}
    return tokens, residency, (eng.prefix_cache.stats if cache else None)


@pytest.mark.cuda
def test_card_bf16_cache_on_off_record(monkeypatch, cuda):
    """Full-width bf16 tokens with the cache on against the cache off, over
    the conversations of chip_smoke.py's prefix phase: once with the fp16
    host pool (the reference's rule) and once, inside this test only, with
    the host pool holding bf16 values.  Recorded per run: the tokens equal
    to the cache-off run's, and each differing request's first differing
    token and the residency of its prefix (cold, served on the device or on
    the host, and where the prefix lay at submit).  A hit's suffix attention
    runs in plain bf16 einsums where the cold prefill ran the flash prefill
    kernel, and a demoted prefix is rounded to fp16, so equality is recorded,
    not asserted; every request finishes and the cache hits."""
    off, _, _ = _conversations(monkeypatch, cache=False)
    record = []
    for host_bf16 in (False, True):
        on, residency, st = _conversations(monkeypatch, cache=True, host_bf16=host_bf16)
        assert st.hits > 0 and st.demoted_pages > 0
        same = sum(x == y for p, toks in on.items() for x, y in zip(toks, off[p]))
        differs = []
        for p, toks in on.items():
            if toks != off[p]:
                first = next((i for i, (x, y) in enumerate(zip(toks, off[p])) if x != y),
                             min(len(toks), len(off[p])))
                differs.append({"prompt_len": len(p), "first_diff": first,
                                "residency": residency[p]})
        record.append({"host_pool": "bf16 values (float32 storage)" if host_bf16
                       else "float16", "tokens_equal": same,
                       "tokens": sum(map(len, off.values())), "differing": differs,
                       "residency": dict(collections.Counter(residency.values())),
                       "hits": st.hits, "inplace_host_hits": st.inplace_host_hits,
                       "demoted_pages": st.demoted_pages, "promoted_pages": st.promoted_pages})
    print(json.dumps({"prefix_bf16_cache_on_vs_off": record}))


def _virtual_clock(dt):
    """A ``time`` stand-in whose clock advances ``dt`` per reading (and by
    the slept time): arrivals meet the same loop turns whatever the host's
    speed."""
    now = [0.0]

    def perf_counter():
        now[0] += dt
        return now[0]

    def sleep(s):
        now[0] += s

    return types.SimpleNamespace(perf_counter=perf_counter, sleep=sleep, time=perf_counter)


class _FrozenConfig:
    """An EngineConfig factory with the perf model frozen (``ewma_alpha=0``)."""

    def __init__(self, cls):
        self.cls = cls

    def __call__(self, **kw):
        return self.cls(**{**kw, "ewma_alpha": 0.0, "hw_profile": "h100_sxm"})

    def __getattr__(self, name):
        return getattr(self.cls, name)


@pytest.mark.cuda
def test_card_cli_prefix_cache_default_pools_virtual_clock(monkeypatch, capsys, cuda):
    """The full-width CLI, ``serve --arch qwen3-0.6b --trace multiturn
    --prefix-cache --require-hits --host-serving`` at its default pools,
    with arrivals on a virtual clock (0.05 s a reading) and the perf model
    frozen, as ``test_cli_prefix_cache_full_width_schedule_matches_reference``
    plans it on the CPU: every gate holds.  Its prefix-cache summary is
    printed, to be held against that CPU run's."""
    monkeypatch.setattr(serve, "time", _virtual_clock(0.05))
    monkeypatch.setattr(serve, "EngineConfig", _FrozenConfig(serve.EngineConfig))
    rc = serve.main(["--arch", "qwen3-0.6b", "--trace", "multiturn", "--prefix-cache",
                     "--require-hits", "--host-serving"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"): out.index("scheduler modes:")])
    keys = ("prefill_tokens_computed", "hit_rate", "prefix_hit_tokens", "prefix_hits",
            "prefix_promoted_pages", "prefix_demoted_pages", "prefix_evicted_pages",
            "prefix_cow_copies", "inplace_host_hits", "host_served_hit_tokens",
            "host_hit_pcie_MB", "planahead_hits", "planahead_replans", "planahead_skipped")
    with capsys.disabled():
        print(json.dumps({"cli_prefix_virtual_clock": {"rc": rc, "gate": out.strip()
                                                       .splitlines()[-1],
                                                       **{k: summary[k] for k in keys}}}))
    assert rc == 0, out[-2000:]
