"""Batch invariance of bf16 decode on the card.

The reference claims bitwise identity between runs that batch rows
differently: pipelined = serial (``tests/test_transfer.py``) and open loop =
closed loop (``launch/serve.py::run_sustained``).  That holds only if a
row's logits do not depend on which rows share its decode pass.  The
executor pads every pass to the reference's row bucket (powers of two, at
least 8), so within one bucket every GEMM runs at the same M; the paged
decode kernel splits a row's pages by its own length.  These tests hold one
row's bf16 logits bitwise equal alone, inside batches of 3 and 8, and
inside a host lane (all bucket 8), and record, without asserting, whether
they change across buckets 8, 16, 32 and 64, and which GEMM of the decode
step changes with the bucket.  Full-width qwen3-0.6b (widths decide the
GEMM shapes), depth cut to 4 layers, random weights.  They carry the
``cuda`` marker and skip without a card; run with ``-s`` to see the record
(one ``decode_invariance`` and one ``gemm_invariance`` JSON line).  No JAX
here: the card's machine has none.
"""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.executor import _bucket  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402

LAYERS = 4
BUCKETS = (8, 16, 32, 64)


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bf16 GEMMs and kernels of the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b").replace(num_layers=LAYERS)
    assert cfg.activation_dtype == "bfloat16"
    eng = NeoEngine(cfg, EngineConfig(device_pool_pages=4096, host_pool_pages=2048,
                                      policy="neo", pipeline=False, hw_profile="h100_sxm",
                                      seed=0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for t in (eng.pool.device.k, eng.pool.device.v):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda").to(t.dtype))
    gc = torch.Generator().manual_seed(2)
    for t in (eng.pool.host.k, eng.pool.host.v):  # in place: HostAttention views them
        t.copy_(torch.randn(t.shape, generator=gc).to(t.dtype))
    yield eng
    eng.close()


def _row(eng, rid, prompt_len, loc, rng):
    vocab = min(1000, eng.cfg.vocab_size)
    r = Request(rid=rid, prompt=list(map(int, rng.integers(1, vocab, prompt_len))),
                max_new_tokens=4)
    r.state = RequestState.RUNNING
    r.location = loc
    r.out_tokens = [int(rng.integers(1, vocab))]
    page = eng.cfg.kv_block_size
    r.pages = eng.pool.pool(loc).alloc(-(-(r.kv_len + 1) // page))
    return r


def _others(eng, n, rng, rid0, loc="gpu"):
    return [_row(eng, rid0 + i, int(rng.integers(17, 700)), loc, rng) for i in range(n)]


def _decode_row(eng, rows, flags, target):
    logits = eng.executor.decode(rows, flags)
    return logits[rows.index(target)]


def _lane_row(eng, rows, target):
    return eng.executor.decode_host_lane(rows, lane=1)[rows.index(target)]


def _record(ref, got):
    return {"bitwise_equal": bool(np.array_equal(ref, got)),
            "max_abs_diff": float(np.abs(ref - got).max()),
            "argmax_equal": bool(ref.argmax() == got.argmax())}


@pytest.mark.cuda
def test_card_decode_row_bitwise_within_bucket(engine):
    """One row's bf16 logits: alone, in batches of 3 and 8 (device rows, and
    with host rows beside it), and a host row inside a host lane and inside
    batch-0 -- all bucket 8, all bitwise equal.  Then batches of 9, 17 and 33
    (buckets 16, 32, 64) are recorded against bucket 8."""
    rng = np.random.default_rng(0)
    eng = engine
    target = _row(eng, 0, 300, "gpu", rng)
    host_target = _row(eng, 1, 200, "cpu", rng)
    alone = _decode_row(eng, [target], [False], target)

    three = _others(eng, 2, rng, 10)
    in3 = _decode_row(eng, [three[0], target, three[1]], [False] * 3, target)
    mixed = _others(eng, 1, rng, 20, "cpu") + _others(eng, 1, rng, 21)
    in3_mixed = _decode_row(eng, [mixed[0], target, mixed[1]], [True, False, False], target)
    eight = _others(eng, 7, rng, 30)
    in8 = _decode_row(eng, eight[:5] + [target] + eight[5:], [False] * 8, target)
    for name, got in (("batch of 3", in3), ("batch of 3 with a host row", in3_mixed),
                      ("batch of 8", in8)):
        assert np.array_equal(alone, got), f"{name}: max |diff| {np.abs(alone - got).max()}"

    lane_alone = _lane_row(eng, [host_target], host_target)
    lane_mates = _others(eng, 4, rng, 40, "cpu")
    lane_in5 = _lane_row(eng, lane_mates[:2] + [host_target] + lane_mates[2:], host_target)
    batch0_host = _decode_row(eng, [three[0], host_target], [False, True], host_target)
    assert np.array_equal(lane_alone, lane_in5)
    assert np.array_equal(lane_alone, batch0_host)

    record = {"bucket 8": "bitwise equal alone, in 3, in 3 with a host row, in 8; "
                          "host row alone, in a lane of 5, in batch-0"}
    many = _others(eng, 32, rng, 100)
    for n in (9, 17, 33):
        rows = many[: n - 1] + [target]
        got = _decode_row(eng, rows, [False] * n, target)
        record[f"bucket {_bucket(n)} (device row)"] = _record(alone, got)
        lane_rows = _others(eng, n - 1, rng, 1000 * n, "cpu") + [host_target]
        record[f"bucket {_bucket(n)} (host lane)"] = _record(
            lane_alone, _lane_row(eng, lane_rows, host_target))
        for r in lane_rows[:-1]:
            eng.pool.host.free(r.pages)
    print(json.dumps({"decode_invariance": record}))


@pytest.mark.cuda
def test_card_gemm_rows_within_and_across_buckets(engine):
    """Each GEMM of the decode step at the full widths, one fixed input row
    among random ones: bitwise the same row of output at M = 8 whatever the
    other rows (asserted); at M = 16, 32, 64 against M = 8 (recorded: the
    GEMMs whose cuBLAS algorithm changes with M)."""
    eng = engine
    model = eng.model
    blk = model.layers[0]
    d, H, hd = eng.cfg.d_model, eng.cfg.num_heads, eng.cfg.head_dim
    gemms = {
        "wq": (d, lambda x: x @ blk.attn["wq"].reshape(d, -1)),
        "wk": (d, lambda x: x @ blk.attn["wk"].reshape(d, -1)),
        "wv": (d, lambda x: x @ blk.attn["wv"].reshape(d, -1)),
        "wo": (H * hd, lambda x: x @ blk.attn["wo"].reshape(H * hd, d)),
        "w_gate": (d, lambda x: x @ blk.mlp["w_gate"]),
        "w_up": (d, lambda x: x @ blk.mlp["w_up"]),
        "w_down": (eng.cfg.d_ff, lambda x: x @ blk.mlp["w_down"]),
        "final_logits": (d, model.final_logits),
    }
    g = torch.Generator(device="cuda").manual_seed(5)
    record = {}
    with torch.inference_mode():
        for name, (K, fn) in gemms.items():
            row = torch.randn(K, generator=g, device="cuda").to(model.act_dtype)
            outs = {}
            for M in BUCKETS:
                x = torch.randn(M, K, generator=g, device="cuda").to(model.act_dtype)
                x[3] = row
                outs[M] = fn(x)[3].float().cpu().numpy()
                if M == 8:  # the same M, other neighbours
                    x2 = torch.randn(M, K, generator=g, device="cuda").to(model.act_dtype)
                    x2[3] = row
                    assert np.array_equal(outs[M], fn(x2)[3].float().cpu().numpy()), name
            record[name] = {f"M={M}": _record(outs[8], outs[M]) for M in BUCKETS[1:]}
    print(json.dumps({"gemm_invariance": record}))


@pytest.mark.cuda
def test_card_prefill_batch_and_placement_record(engine):
    """What else can make two runs that batch rows differently diverge
    (recorded, not asserted): a prompt's first-token logits and K/V
    prefilled alone or inside a padded batch of 4 (every prefill GEMM at M =
    S alone, M = B x S_pad batched, and the flash prefill kernel's rows);
    and one decode row attended on the card (bf16 device pool, the paged
    decode kernel) or on the host (fp16 host pool, numpy)."""
    eng = engine
    model = eng.model
    rng = np.random.default_rng(9)
    vocab = min(1000, eng.cfg.vocab_size)
    n, S_pad, where = 300, 700, 1
    prompt = torch.from_numpy(rng.integers(1, vocab, n)).long()
    alone_logits, alone = model.prefill(prompt[None], true_lens=torch.tensor([n]))
    tokens = torch.from_numpy(rng.integers(1, vocab, (4, S_pad))).long()
    tokens[where, :n] = prompt
    tokens[where, n:] = 0
    lens = torch.tensor([S_pad, n, 450, 120])
    batch_logits, batch = model.prefill(tokens, true_lens=lens)
    record = {"prefill first-token logits": _record(
        alone_logits[0].float().cpu().numpy(), batch_logits[where].float().cpu().numpy())}
    for li in (0, LAYERS - 1):
        record[f"prefill K layer {li}"] = _record(
            alone["k"][li, 0, :n].float().cpu().numpy(),
            batch["k"][li, where, :n].float().cpu().numpy())

    from repro_torch.kernels.flash_prefill.ops import flash_prefill

    g = torch.Generator(device="cuda").manual_seed(6)
    H, KV, hd = eng.cfg.num_heads, eng.cfg.num_kv_heads, eng.cfg.head_dim
    qkv = [torch.randn(4, S_pad, h, hd, generator=g, device="cuda").to(model.act_dtype)
           for h in (H, KV, KV)]
    one = flash_prefill(*(t[where:where + 1, :n].contiguous() for t in qkv))
    many = flash_prefill(*qkv)
    record["flash_prefill row (S=300 alone vs S_pad=700 in 4)"] = _record(
        one[0].float().cpu().numpy(), many[where, :n].float().cpu().numpy())

    blk = model.layers[0]
    d, f = eng.cfg.d_model, eng.cfg.d_ff
    gemms = {"wq": (d, blk.attn["wq"].reshape(d, -1)), "wk": (d, blk.attn["wk"].reshape(d, -1)),
             "wv": (d, blk.attn["wv"].reshape(d, -1)),
             "wo": (H * hd, blk.attn["wo"].reshape(H * hd, d)),
             "w_gate": (d, blk.mlp["w_gate"]), "w_up": (d, blk.mlp["w_up"]),
             "w_down": (f, blk.mlp["w_down"])}
    with torch.inference_mode():
        for name, (K, w) in gemms.items():
            x = torch.randn(4 * S_pad, K, generator=g, device="cuda").to(model.act_dtype)
            rows = slice(where * S_pad, where * S_pad + n)
            record[f"prefill GEMM {name} (M={n} vs M={4 * S_pad})"] = _record(
                (x[rows].contiguous() @ w).float().cpu().numpy(),
                (x @ w)[rows].float().cpu().numpy())

    # one decode row on the card, then on the host over the same K/V
    row = _row(eng, 7000, 250, "gpu", rng)
    dev_logits = _decode_row(eng, [row], [False], row)
    host_row = _row(eng, 7001, 250, "cpu", rng)
    host_row.prompt, host_row.out_tokens = row.prompt, row.out_tokens
    k, v = eng.pool.device.read_pages(row.pages)
    eng.pool.host.put_pages(host_row.pages, k, v)
    host_logits = _decode_row(eng, [host_row], [True], host_row)
    record["decode row on the card vs on the host"] = _record(dev_logits, host_logits)
    print(json.dumps({"prefill_and_placement": record}))


@pytest.mark.cuda
def test_card_recomputed_kv_vs_decoded_kv_record(engine):
    """A request preempted by recompute gets its K/V back from a prefill of
    prompt + outputs (the flash prefill kernel, GEMMs at M = S), where an
    unpreempted one keeps the K/V its decode steps wrote (the paged decode
    kernel, GEMMs at M = 8).  Recorded: whether the two agree bitwise at the
    decoded positions, and the next step's logits from each."""
    eng = engine
    rng = np.random.default_rng(12)
    page = eng.cfg.kv_block_size
    steps = 8
    a = _row(eng, 8000, 200, "gpu", rng)
    a.out_tokens = []
    a.pages = a.pages + eng.pool.device.alloc(1)
    first = eng.executor.prefill([a], [False])
    a.out_tokens = [int(first[0].argmax())]
    for _ in range(steps):
        a.out_tokens.append(int(eng.executor.decode([a], [False])[0].argmax()))
    b = Request(rid=8001, prompt=list(a.prompt), max_new_tokens=4)
    b.state, b.location, b.out_tokens = RequestState.RUNNING, "gpu", list(a.out_tokens)
    b.pages = eng.pool.device.alloc(len(a.pages))
    eng.executor.prefill([b], [False])  # the replay: prompt + out[:-1]
    ka, va = eng.pool.device.read_pages(a.pages)
    kb, vb = eng.pool.device.read_pages(b.pages)
    L = ka.shape[0]
    decoded = slice(len(a.prompt), a.kv_len)  # positions the decode steps wrote
    flat = lambda t: t.reshape(L, -1, *t.shape[3:])[:, decoded].float().cpu().numpy()
    record = {"K, layer 0": _record(flat(ka)[0], flat(kb)[0]),
              "K, last layer": _record(flat(ka)[-1], flat(kb)[-1]),
              "V, last layer": _record(flat(va)[-1], flat(vb)[-1]),
              "next-step logits": _record(eng.executor.decode([a], [False])[0],
                                          eng.executor.decode([b], [False])[0])}
    assert a.kv_len == b.kv_len and len(a.pages) * page > a.kv_len
    print(json.dumps({"recompute_vs_decoded": record}))


# The A/B's schedule is pinned: arrivals follow a virtual clock that
# advances a fixed step per reading of the serve loop's clock (and by the
# slept time), and the perf model is frozen (ewma_alpha=0), so the plans
# follow from the inputs alone, the same on the card as in the CPU
# rehearsal (tests/test_torch_serve.py::test_sustained_virtual_clock_schedule).
# With ONE step for both loops they see every arrival at the same turn and
# plan alike: no request's residency differs, and the record tests nothing.
# The closed loop takes 0.05 s a reading (the step of
# test_card_cli_prefix_cache_default_pools_virtual_clock) and the open loop,
# whose plan-ahead takes planning off its critical path, 0.04 s: the
# smallest of the paces tried (0.045, 0.04, 0.03) that moves requests'
# residency early in their output, 5 of 16, from their 1st to 9th token.
SUSTAINED_STEPS = {"closed": 0.05, "open": 0.04}


class _VirtualClock:
    """A ``time`` stand-in whose clock advances ``dt`` per reading (and by
    the slept time); ``dt`` is set per loop."""

    def __init__(self):
        self.now, self.dt = 0.0, 0.0

    def perf_counter(self):
        self.now += self.dt
        return self.now

    time = perf_counter

    def sleep(self, s):
        self.now += s


def _frozen_config(cls):
    """An EngineConfig factory with the perf model frozen (``ewma_alpha=0``)."""
    def make(**kw):
        return cls(**{**kw, "ewma_alpha": 0.0, "hw_profile": "h100_sxm"})
    return make


def _sustained_loops(monkeypatch, host_bf16: bool) -> dict:
    """One ``--sustained`` A/B run (closed-loop lockstep, then open loop +
    plan-ahead) on the pinned schedule (``SUSTAINED_STEPS``), each engine
    traced, with each request's moves (prefill into a pool, swap-out,
    swap-in) logged at the iteration that launched them.  With ``host_bf16``
    the host pool holds the device pool's bf16 values exactly: numpy has no
    bfloat16, so the pool stores them in float32 (every value written is a
    bf16 activation or a bf16 device page).  Returns the record of the run."""
    from repro_torch.core.kv_cache import PagePool
    from repro_torch.launch import serve
    from repro_torch.obs import SpanTracer

    engines = []
    init = NeoEngine.__init__
    init_pool = PagePool.__init__
    clock = _VirtualClock()

    def counted_init(self, *a, **k):
        init(self, *a, **k)
        clock.dt = SUSTAINED_STEPS["closed" if not engines else "open"]
        self.attach_tracer(SpanTracer(1 << 20))
        moves = collections.defaultdict(list)  # rid -> [(iter, move)]
        engines.append((self, moves))
        prefill = self.executor.prefill

        def log_prefill(reqs, to_host):
            for r, host in zip(reqs, to_host):
                moves[r.rid].append((self.stats.iterations, "cpu" if host else "gpu"))
            return prefill(reqs, to_host)

        self.executor.prefill = log_prefill
        for name, where in (("swap_out", "cpu"), ("swap_in", "gpu")):
            fn = getattr(self.transfer, name)

            def log_swap(req, _fn=fn, _name=name, _where=where):
                assert self.transfer.trace_iter == self.stats.iterations
                moves[req.rid].append((self.stats.iterations, f"{_name}->{_where}"))
                return _fn(req)

            setattr(self.transfer, name, log_swap)

    def f32_host_pool(self, cfg, num_pages, *, backend, device, num_layers=None):
        init_pool(self, cfg, num_pages, backend=backend, device=device, num_layers=num_layers)
        if backend == "host":
            self.dtype = torch.float32
            self.k = torch.zeros(self.k.shape, dtype=torch.float32, pin_memory=self.pinned)
            self.v = torch.zeros(self.v.shape, dtype=torch.float32, pin_memory=self.pinned)

    with monkeypatch.context() as mp:
        mp.setattr(NeoEngine, "__init__", counted_init)
        mp.setattr(serve, "time", clock)
        mp.setattr(serve, "EngineConfig", _frozen_config(serve.EngineConfig))
        if host_bf16:
            mp.setattr(PagePool, "__init__", f32_host_pool)
        result = serve.run_sustained(arch="qwen3-0.6b", smoke=False, device="cuda", n=16,
                                     rate=4.0, device_pages=64, host_pages=256)
    loops = {"closed": engines[0], "open": engines[1]}
    for eng, _ in loops.values():
        host = eng.pool.host
        assert host.dtype == (torch.float32 if host_bf16 else torch.float16)
        if host_bf16:  # the values a bf16 pool would hold, exactly
            for t in (host.k, host.v):
                assert torch.equal(t, t.bfloat16().float())

    def residency(eng, moves):
        """Per request, where its K/V lay when each of its tokens was
        emitted (the iteration of a ``tok`` event is the ``step`` span that
        holds it), checked against the tracer's copy spans."""
        evs = eng.tracer.events()
        assert eng.tracer.dropped == 0
        steps = sorted((e.t0, e.t1, e.args["iter"]) for e in evs
                       if e.ph == "X" and e.track == "engine" and e.name == "step")
        copies = collections.Counter((e.name, e.args["iter"]) for e in evs
                                     if e.ph == "X" and e.track.startswith("copy-"))
        swaps = collections.Counter((m.split("->")[0][5:], it) for ms in moves.values()
                                    for it, m in ms if m.startswith("swap"))
        assert copies == swaps  # one copy span per swap, at the iteration that launched it
        where = {}
        for e in evs:
            if e.ph == "n" and e.name == "tok":
                it = next(i for t0, t1, i in steps if t0 <= e.t0 <= t1)
                loc = None
                for mit, m in moves[e.rid]:
                    if mit <= it:
                        loc = m.split("->")[-1]
                where.setdefault(e.rid, []).append((it, loc))
        return where

    res = {name: residency(*loop) for name, loop in loops.items()}
    closed, open_ = loops["closed"][0], loops["open"][0]
    diverged, moved = {}, {}
    for rid, r in closed.requests.items():
        x, y = r.out_tokens, open_.requests[rid].out_tokens
        lc = [loc for _, loc in res["closed"][rid]]
        lo = [loc for _, loc in res["open"][rid]]
        if lc != lo:
            moved[rid] = next((i for i, (a, b) in enumerate(zip(lc, lo)) if a != b),
                              min(len(lc), len(lo)))
        if x != y:
            first = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
            diverged[rid] = {"first_diff": first, "tokens": len(x), **{
                name: {"moves": loops[name][1][rid], "token_iter": res[name][rid][first][0],
                       "residency": res[name][rid][first][1],
                       "residency_by_token": [loc for _, loc in res[name][rid]]}
                for name in loops}}
    return {"host_pool": "bf16 values (float32 storage)" if host_bf16 else "float16",
            "clock_steps": SUSTAINED_STEPS,
            "bitwise_identical": result["gates"]["bitwise_identical"],
            "requests": len(closed.requests), "diverged": diverged,
            "residency_differs_from_token": moved}


@pytest.mark.cuda
def test_card_sustained_divergence_record(monkeypatch):
    """The serve CLI's ``--sustained`` A/B (closed-loop lockstep vs open loop
    + plan-ahead, full-width qwen3-0.6b, 16 osc requests at 4 req/s, pools
    64/256 pages) on a pinned schedule (virtual arrival clocks, perf model
    frozen: ``SUSTAINED_STEPS``), run twice: with the fp16 host pool (the
    reference's rule) and again, inside this test only, with the host pool
    holding bf16 values.  Both runs have the same schedule, in which 5
    requests' residency differs between the loops.  Each engine is traced;
    each request's residency at each of its tokens comes from the tracer's
    ``tok`` and ``step`` events and its logged moves, held to the tracer's
    ``copy-*`` spans.  Recorded: which requests' tokens differ, where they
    first differ, and where each loop kept their K/V then.

    Asserted: a request's tokens differ between the loops only after its
    residency differed; with the host pool holding bf16 values the loops are
    bitwise identical although the plans kept some requests in other pools,
    so the fp16 host pool's rounding is what moves the tokens (host
    attention in numpy gives the paged decode kernel's bf16 outputs).
    Whether the fp16 run diverges is recorded, not asserted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    records = [_sustained_loops(monkeypatch, host_bf16) for host_bf16 in (False, True)]
    print(json.dumps({"sustained_divergence": records}))
    for rec in records:
        for rid, d in rec["diverged"].items():
            assert rec["residency_differs_from_token"].get(rid, d["first_diff"] + 1) \
                <= d["first_diff"], (rec["host_pool"], rid, d)
    bf16 = records[1]
    assert bf16["residency_differs_from_token"], "no request changed residency: nothing tested"
    assert bf16["bitwise_identical"] and not bf16["diverged"], bf16

