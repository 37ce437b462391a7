"""The port's engine benchmarks (``repro_torch.benchmarks.engine_real`` and
``.prefix_cache``) against the JAX package's (``benchmarks/engine_real.py``,
``benchmarks/prefix_cache.py``), on the CPU at the smoke size (qwen3-0.6b:
4 layers, d_model 128, fp32).

Both sides serve the same weights (the reference's ``init(key(0))``, carried
over by ``models/bridge.py``) with the perf model frozen and the H100
profile: on the reference side the name ``EngineConfig`` in each benchmark
module's namespace is replaced, for the test only, by ``EngineConfig`` with
``ewma_alpha=0`` and ``hw_profile="h100_sxm"``; the reference's files stay as
they are.  The reference's ``main``s write their JSON under ``experiments/figures/``
(tracked), so the tests call its sections' functions, which return dicts,
and no tracked file changes; ``run``'s warmup burst is cut to one request
on both sides (it only warms caches; the stats reset after it).

Per section, the gate verdict (rc), the greedy tokens request by request,
and the counters that follow from the plans are the reference's:
iterations, offloaded and device decodes, swap MB, modes, micro-batched /
serial batch-1 / borrowed-lane steps, lane counts, the speculation counts
and histogram, every prefix-cache counter and the prefill tokens.  The
wall-time figures (tok/s, bubble fraction, tracing overhead, the oracle
speedup) differ between any two runs and are compared only through the
verdicts; plan-ahead's counters follow timing and are left out.  Each
reference section runs once, in a module-scoped fixture.
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from benchmarks import engine_real as ref_er  # noqa: E402
from benchmarks import prefix_cache as ref_pc  # noqa: E402
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.benchmarks import engine_real, prefix_cache  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

ARCH = "qwen3-0.6b"
N = 3  # requests of the engine_real bursts (the spec section takes min(n, 3) as well)
RUN_KEYS = ("requests_done", "iterations", "offloaded", "device", "swap_MB", "modes",
            "microbatched_steps", "serial_b1_steps", "borrowed_lane_steps", "lane_count_steps",
            "spec_steps", "drafted_tokens", "accepted_tokens", "rejected_drafts",
            "accept_len_hist")
LOCKSTEP_KEYS = ("iterations", "offloaded", "borrowed_lane_steps", "microbatched_steps",
                 "lane_count_steps")
PREFIX_KEYS = ("prefill_tok", "iterations", "hit_rate", "hit_tokens", "promoted", "demoted",
               "evicted", "cow", "inplace_host_hits", "host_served_hit_tokens",
               "host_hit_pcie_bytes")


def _recording(fn, runs, key):
    """``fn`` recording each call's outputs (the second item of its
    result) under ``key(args, kwargs)``, first call of a key only."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        runs.setdefault(key(a, k), res[1])
        return res
    return wrapped


def _run_key(a, k):
    return (a[0], a[1], k.get("microbatch", True), k.get("tracing", False),
            k.get("spec", False), k.get("oracle_from") is not None)


def _lockstep_key(a, k):
    return ("lockstep", k.get("pipeline", True))


def _prefix_key(a, k):
    return (a[0], k.get("device_pages"), k.get("token_granular", True))


def _one_warmup_request(get_trace):
    """``get_trace`` with ``run``'s warmup burst (6 osc requests, seed 1)
    cut to one request: the warmup settles compile caches before the timed
    burst, the stats are reset after it, and the perf model is frozen, so
    the timed burst's plans and tokens do not depend on its size (its draws
    from the prompt generator do, alike on both sides)."""
    def cut(name, n, rate, seed=0):
        return get_trace(name, 1 if (n, seed) == (6, 1) else n, rate, seed)
    return cut


@contextlib.contextmanager
def recorded(er, pc):
    """The engine_real and prefix_cache modules ``er`` and ``pc`` with each
    run's outputs recorded and ``run``'s warmup burst cut to one request; on
    the reference's side (``frozen``) also the perf model frozen and the
    H100 profile.  Yields the recorded outputs."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(er, "run", _recording(er.run, runs, _run_key))
        mp.setattr(er, "run_lockstep", _recording(er.run_lockstep, runs, _lockstep_key))
        mp.setattr(er, "get_trace", _one_warmup_request(er.get_trace))
        mp.setattr(pc, "run", _recording(pc.run, runs, _prefix_key))
        if er is ref_er:
            frozen = functools.partial(RefEngineConfig, ewma_alpha=0.0, hw_profile="h100_sxm")
            mp.setattr(ref_er, "EngineConfig", frozen)
            mp.setattr(ref_pc, "EngineConfig", frozen)
        yield runs


@pytest.fixture(scope="module")
def opts():
    """The port's options: smoke width on the CPU, the reference's weights,
    the perf model frozen."""
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(0))
    state = params_from_reference(jax.tree.map(np.asarray, params), get_smoke_config(ARCH))
    return dict(smoke=True, device="cpu", params=state, ewma_alpha=0.0, ref_params=params)


def _engine_real_sections(mod, traced_once=False, **opts):
    """The sections ``main`` runs after its policy table, sharing the
    fastdecode run as ``main`` does.  With ``traced_once`` the tracing
    section's verdict is taken from one traced run (outputs equal to the
    untraced run's, ``reconcile`` ok, nothing dropped: the section's rc,
    which leaves its wall-time overhead out) instead of the section, whose
    re-measure of the overhead would add runs on a loaded host."""
    opts = {k: v for k, v in opts.items() if k != "ref_params"}
    fd = mod.run("fastdecode", N, pipeline=True, **opts)
    rc_mb, mb = mod.run_microbatch_section(N, on=fd, **opts)
    if traced_once:
        r_on, out_on = mod.run("fastdecode", N, pipeline=True, microbatch=True, tracing=True,
                               **opts)
        rc_obs = int(not (out_on == fd[1] and r_on["reconcile_ok"]
                          and r_on["trace_dropped"] == 0))
        overhead = max(0.0, 1.0 - r_on["token_throughput"] / fd[0]["token_throughput"])
        obs = {"obs_tracing_off": fd[0],
               "obs_tracing_on": dict(r_on, tracing_overhead=round(overhead, 4))}
    else:
        rc_obs, obs = mod.run_obs_section(N, off=fd, **opts)
    rc_sp, sp = mod.run_spec_section(N, **opts)
    rc_ml, ml = mod.run_mixed_lane_section(**opts)
    return {"rc": {"microbatch": rc_mb, "obs": rc_obs, "spec": rc_sp, "mixed_lane": rc_ml},
            "results": {**mb, **obs, **sp, **ml}}


@pytest.fixture(scope="module")
def engine_real_runs(opts):
    with recorded(ref_er, ref_pc) as runs:
        ref = _engine_real_sections(ref_er, traced_once=True)
    with recorded(engine_real, prefix_cache) as port_runs:
        port = _engine_real_sections(engine_real, **opts)
    return {"ref": dict(ref, outputs=runs), "port": dict(port, outputs=port_runs)}


def _prefix_section(mod, convs, warm, **common):
    """``main``'s work on given conversations: cache off and on at 96/256
    pages, then ``run_host_serving`` at 256 host pages; (rc, results)."""
    off, out_off = mod.run(False, convs, warm, device_pages=96, host_pages=256, **common)
    on, out_on = mod.run(True, convs, warm, device_pages=96, host_pages=256, **common)
    rc, hs = mod.run_host_serving(convs, warm, host_pages=256, **common)
    same = out_off == out_on
    reduction = off["prefill_tok"] / max(1, on["prefill_tok"])
    rc = rc or int(not same or reduction < 2.0)
    return rc, {"cache_off": off, "cache_on": on, "prefill_reduction": round(reduction, 2),
                "outputs_identical": same, **hs}


@pytest.fixture(scope="module")
def prefix_runs(opts):
    """The prefix section on one conversation of 3 turns after a warmup
    conversation of 2 (``main`` builds them from ``--n``; its smallest
    warmup is 4 turns), through the sections' functions on both sides."""
    vocab = ref_smoke(ARCH).vocab_size
    convs = prefix_cache.build_conversations(3, 3, seed=0, vocab=vocab)
    warm = prefix_cache.build_conversations(2, 2, seed=7, vocab=vocab)
    cfg_ref = ref_smoke(ARCH)
    with recorded(ref_er, ref_pc) as runs:
        ref = _prefix_section(ref_pc, convs, warm, params=opts["ref_params"], cfg=cfg_ref)
    with recorded(engine_real, prefix_cache) as port_runs:
        port = _prefix_section(prefix_cache, convs, warm, params=opts["params"],
                               cfg=get_smoke_config(ARCH), device="cpu", ewma_alpha=0.0)
    return {"ref": (*ref, runs), "port": (*port, port_runs)}


@pytest.mark.parametrize("section", ["microbatch", "obs", "spec", "mixed_lane"])
def test_engine_real_section_verdicts(engine_real_runs, section):
    """Each section's gate verdict is the reference's (and passes)."""
    ref, port = engine_real_runs["ref"], engine_real_runs["port"]
    assert port["rc"][section] == ref["rc"][section] == 0


@pytest.mark.parametrize("run", ["fastdecode_mb_off", "fastdecode_mb_on", "obs_tracing_off",
                                 "obs_tracing_on", "spec_off", "spec_ngram", "spec_oracle"])
def test_engine_real_run_counters(engine_real_runs, run):
    ref = engine_real_runs["ref"]["results"][run]
    port = engine_real_runs["port"]["results"][run]
    assert {k: port[k] for k in RUN_KEYS} == {k: ref[k] for k in RUN_KEYS}
    assert set(port) == set(ref)  # the reference's JSON keys
    if run == "obs_tracing_on":
        assert port["reconcile_ok"] and ref["reconcile_ok"]
        assert port["trace_dropped"] == ref["trace_dropped"] == 0


@pytest.mark.parametrize("run", ["mixed_serial", "mixed_pipelined"])
def test_engine_real_lockstep_counters(engine_real_runs, run):
    ref = engine_real_runs["ref"]["results"][run]
    port = engine_real_runs["port"]["results"][run]
    assert {k: port[k] for k in LOCKSTEP_KEYS} == {k: ref[k] for k in LOCKSTEP_KEYS}
    assert set(port) == set(ref)


def test_engine_real_tokens(engine_real_runs):
    """Greedy tokens request by request, run by run (the burst under every
    policy, micro-batching, tracing and drafter the sections use, and the
    lockstep runs); the reference's runs that re-measure a wall-time gate
    after a first miss are the same runs again."""
    ref = engine_real_runs["ref"]["outputs"]
    port = engine_real_runs["port"]["outputs"]
    assert port.keys() == ref.keys() and len(port) == 7
    for key in ref:
        assert port[key] == ref[key], key
        assert sum(len(v) for v in port[key].values()) > 0


def test_engine_real_spec_gates(engine_real_runs):
    ref = engine_real_runs["ref"]["results"]["spec_gates"]
    port = engine_real_runs["port"]["results"]["spec_gates"]
    assert port["bitwise_ok"] and ref["bitwise_ok"]
    assert (port["oracle_speedup"] > 1.0) == (ref["oracle_speedup"] > 1.0)


def test_oracle_drafter_is_the_references():
    """The one replay drafter (``chip_smoke.py`` imports it) proposes what
    the reference's ``_OracleDrafter`` does, fed one request at a time or
    built from (prompts, outputs)."""
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, 50, size=n))) for n in (5, 9, 3)]
    outs = [list(map(int, rng.integers(1, 50, size=n))) for n in (6, 4, 7)]
    ref = ref_er._OracleDrafter()
    for p, o in zip(prompts, outs):
        ref.feed(p, o)
    for port in (engine_real.OracleDrafter(prompts, outs), engine_real.OracleDrafter()):
        if not port.table:
            for p, o in zip(prompts, outs):
                port.feed(p, o)
        assert port.table == ref.table
        for p, o in zip(prompts, outs):
            for t in range(len(o) + 1):
                assert port.propose(p + o[:t], 4) == ref.propose(p + o[:t], 4)


def test_prefix_cache_section(prefix_runs):
    """With host serving: the verdict, every counter of each run, the
    prefill reduction, the token-granular gain and both bitwise gates are
    the reference's."""
    (rc_ref, ref, _), (rc_port, port, _) = prefix_runs["ref"], prefix_runs["port"]
    assert rc_port == rc_ref == 0
    assert set(port) == set(ref)
    for run in ("cache_off", "cache_on", "hs_cache_off", "hs_cache_on", "hs_page_aligned"):
        assert {k: port[run][k] for k in PREFIX_KEYS} == {k: ref[run][k] for k in PREFIX_KEYS}
    for key in ("prefill_reduction", "outputs_identical", "hs_outputs_identical",
                "hs_token_granular_extra_hit_tokens"):
        assert port[key] == ref[key], key
    assert port["prefill_reduction"] >= 2.0 and port["hs_cache_on"]["inplace_host_hits"] > 0


def test_prefix_cache_tokens(prefix_runs):
    """Greedy tokens turn by turn of each of the section's five runs (cache
    off and on with the 96-page device pool, then off, on and page-aligned
    with 16 pages), keyed (conversation, prompt length)."""
    ref, port = prefix_runs["ref"][2], prefix_runs["port"][2]
    assert port.keys() == ref.keys() and len(port) == 5
    for key in ref:
        assert port[key] == ref[key], key
        assert len(port[key]) == 3


def test_prefix_cache_conversations():
    """The multiturn conversations the section serves are the reference's,
    turn order included."""
    vocab = ref_smoke(ARCH).vocab_size
    for n, turns, seed in ((8, 4, 0), (4, 4, 0), (4, 4, 7), (6, 3, 3)):
        convs_ref = ref_pc.build_conversations(n, turns, seed=seed, vocab=vocab)
        convs = prefix_cache.build_conversations(n, turns, seed=seed, vocab=vocab)
        assert [[(t.prompt, t.output_len) for t in c] for c in convs] == \
            [[(t.prompt, t.output_len) for t in c] for c in convs_ref]
