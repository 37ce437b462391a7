"""Gather-TP serving of the port against the JAX package's tensor-parallel
engine, on the CPU.

The reference drives TP=2 on a mesh of fake XLA host devices, so its runs go
into one subprocess (``tests.conftest.run_subprocess``) that prints their
results as JSON; the port runs in this process on two CPU shards with the
same weights, carried across by the bridge (the subprocess checks that its
weights are the ones given here).  Both sides freeze the perf model
(``ewma_alpha=0``) and price the H100 profile, so the plans follow the
prompts alone.  Scenarios: those of ``tests/test_sharded_engine.py``
(fastdecode 24/128 pages, neo 10/128), ``tests/test_obs.py``'s traced TP=2
run, a prefix-cache run whose host rows are served in place, and an n-gram
speculation run.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from tests.conftest import run_subprocess  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.host_attention import HostAttention  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402
from repro_torch.distributed.sharding import gather_tp_spec, tp_allgather  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_reference, shard_state_dict  # noqa: E402
from repro_torch.obs import reconcile  # noqa: E402
from repro_torch.obs.validate import validate  # noqa: E402

ARCH = "qwen3-0.6b"
CFG = get_smoke_config(ARCH)
SEED = 7
PAGE = CFG.kv_block_size


def _rand_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]


def _granular_prompts():
    """Prompts sharing a prefix at lengths off the page boundary
    (``tests/test_torch_prefix_cache.py``)."""
    rng = np.random.default_rng(3)
    base = list(map(int, rng.integers(1, 500, size=2 * PAGE + 5)))
    prompts = [base + list(map(int, rng.integers(1, 500, size=int(rng.integers(1, 12)))))
               for _ in range(3)]
    return prompts + [base[: PAGE + 3] + list(map(int, rng.integers(1, 500, size=7)))]


def _repeat_prompts():
    """Repetition the n-gram drafter can use (``tests/test_torch_spec_decode.py``)."""
    rng = np.random.default_rng(11)
    base = list(map(int, rng.integers(1, 500, size=8)))
    return [base * 3 + list(map(int, rng.integers(1, 500, size=n))) for n in (5, 9, 7)]


# name: (engine options, prompt waves, outputs).  A wave is submitted at
# once and run to its end before the next (the prefix run's first wave
# seeds the tree).
SCENARIOS = {
    "fastdecode": (dict(device_pool_pages=24, host_pool_pages=128, max_batch_tokens=1024,
                        policy="fastdecode"), [_rand_prompts(0, [12 + i for i in range(4)])], 8),
    "neo": (dict(device_pool_pages=10, host_pool_pages=128, max_batch_tokens=1024,
                 policy="neo"), [_rand_prompts(0, [24 + 3 * i for i in range(6)])], 12),
    "neo-traced": (dict(device_pool_pages=10, host_pool_pages=64, max_batch_tokens=1024,
                        policy="neo", tracing=True),
                   [_rand_prompts(0, [24 + 3 * i for i in range(4)])], 6),
    "prefix-host": (dict(device_pool_pages=8, host_pool_pages=10, max_batch_tokens=256,
                         policy="fastdecode", starvation_limit=2, prefix_cache=True),
                    [_granular_prompts()[:1], _granular_prompts()[1:]], 16),
    "ngram-neo": (dict(device_pool_pages=8, host_pool_pages=128, max_batch_tokens=256,
                       policy="neo", microbatch=True, planahead=False, spec_decode=True),
                  [_repeat_prompts()], 8),
}
SPEC_FIELDS = ("spec_steps", "drafted_tokens", "accepted_tokens", "rejected_drafts")


def _result(eng, tokens):
    """What both sides must agree on, JSON-shaped (int keys as strings)."""
    s, ts = eng.stats, eng.transfer.stats
    out = dict(tokens=tokens, swap_bytes=eng.pool.swap_bytes,
               swap_out_bytes=s.swap_out_bytes, swap_in_bytes=s.swap_in_bytes,
               transfer_bytes=[ts.bytes_out, ts.bytes_in],
               bytes_by_stream=dict(sorted(ts.bytes_by_stream.items())),
               mode_counts=dict(sorted(s.mode_counts.items())),
               lane_counts={str(k): v for k, v in sorted(s.lane_counts.items())},
               offloaded_decodes=s.offloaded_decodes, device_decodes=s.device_decodes,
               plans=list(s.plans), spec={f: getattr(s, f) for f in SPEC_FIELDS},
               finished=all(r.state.name == "FINISHED" for r in eng.requests.values()))
    if eng.prefix_cache is not None:
        out["prefix"] = dataclasses.asdict(eng.prefix_cache.stats)
    return out


def _drive(eng, waves, n_out):
    tokens = []
    for wave in waves:
        rids = [eng.submit(p, n_out) for p in wave]
        done = eng.run_until_done(500)
        tokens += [list(done[r]) for r in rids]
    return tokens


# The reference's side, in a subprocess with 8 fake host devices: every
# scenario at TP=2, plus a checksum of the weights it drew.
REF_CODE = """
import dataclasses, json
import jax
import numpy as np
from repro.config import EngineConfig
from repro.configs import get_smoke_config
from repro.core.engine import NeoEngine
from repro.models.api import get_model
from repro.obs.tracer import SpanTracer

cfg = get_smoke_config(%(arch)r)
params = get_model(cfg).init(jax.random.key(%(seed)d))
checksum = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                     for x in jax.tree.leaves(params)))
scenarios = json.loads(%(scenarios)r)
SPEC_FIELDS = %(spec_fields)r
out = {"checksum": checksum}
for name, (opts, waves, n_out) in scenarios.items():
    tracing = opts.pop("tracing", False)
    eng = NeoEngine(cfg, EngineConfig(hw_profile="h100_sxm", ewma_alpha=0.0, tp=2, **opts),
                    params=params)
    tracer = None
    if tracing:
        tracer = SpanTracer()
        eng.attach_tracer(tracer)
    tokens = []
    for wave in waves:
        rids = [eng.submit(p, n_out) for p in wave]
        done = eng.run_until_done(500)
        tokens += [list(map(int, done[r])) for r in rids]
    eng.close()
    s, ts = eng.stats, eng.transfer.stats
    res = dict(tokens=tokens, swap_bytes=eng.pool.swap_bytes,
               swap_out_bytes=s.swap_out_bytes, swap_in_bytes=s.swap_in_bytes,
               transfer_bytes=[ts.bytes_out, ts.bytes_in],
               bytes_by_stream=dict(sorted(ts.bytes_by_stream.items())),
               mode_counts=dict(sorted(s.mode_counts.items())),
               lane_counts={str(k): v for k, v in sorted(s.lane_counts.items())},
               offloaded_decodes=s.offloaded_decodes, device_decodes=s.device_decodes,
               plans=list(s.plans), spec={f: getattr(s, f) for f in SPEC_FIELDS},
               finished=all(r.state.name == "FINISHED" for r in eng.requests.values()))
    if eng.prefix_cache is not None:
        res["prefix"] = dataclasses.asdict(eng.prefix_cache.stats)
    if tracer is not None:
        res["shard_tracks"] = sorted(t for t in tracer.tracks() if t.endswith(("-s0", "-s1")))
    out[name] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def weights():
    """(port state dict, checksum of the reference's weights)."""
    params = ref_get_model(ref_smoke(ARCH)).init(jax.random.key(SEED))
    leaves = jax.tree.map(np.asarray, params)
    checksum = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                         for x in jax.tree.leaves(leaves)))
    return params_from_reference(leaves, CFG), checksum


@pytest.fixture(scope="module")
def reference():
    code = REF_CODE % dict(arch=ARCH, seed=SEED, scenarios=json.dumps(SCENARIOS),
                           spec_fields=SPEC_FIELDS)
    return json.loads(run_subprocess(code).strip().splitlines()[-1])


def _port(weights, name, tp, *, shard_devices=None, record=None):
    """One port run of scenario ``name``; ``record`` collects the logits of
    every sampled token."""
    opts, waves, n_out = SCENARIOS[name]
    opts = dict(opts)
    tracing = opts.pop("tracing", False)
    eng = NeoEngine(CFG, EngineConfig(hw_profile="h100_sxm", ewma_alpha=0.0, tp=tp,
                                      tracing=tracing, **opts),
                    params=weights[0], device="cpu", shard_devices=shard_devices)
    if record is not None:
        sample = eng._sample
        eng._sample = lambda logits: record.append(np.array(logits)) or sample(logits)
    try:
        return _result(eng, _drive(eng, waves, n_out)), eng
    finally:
        eng.close()


@pytest.fixture(scope="module")
def port(weights):
    """Every scenario on the port at TP=2 and at TP=1: (result, engine)."""
    return {(name, tp): _port(weights, name, tp) for name in SCENARIOS for tp in (1, 2)}


def test_reference_weights_are_the_ports(weights, reference):
    assert reference["checksum"] == weights[1]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp2_matches_reference_tp2(name, reference, port):
    """Tokens, swap accounting (per copy stream too), modes, lanes, plans,
    the prefix cache's and speculation's counters: the reference's at
    TP=2."""
    ref = {k: v for k, v in reference[name].items() if k != "shard_tracks"}
    got, eng = port[name, 2]
    assert got["finished"] and ref["finished"]
    assert got == ref, name
    if name == "neo":
        st = got["bytes_by_stream"]
        assert set(st) == {"out0", "out1"} and got["transfer_bytes"][0] > 0, st
        assert sum(st.values()) == sum(got["transfer_bytes"])
    if name == "prefix-host":
        assert got["prefix"]["inplace_host_hits"] > 0, "no host row was served in place"
    if name == "ngram-neo":
        assert got["spec"]["accepted_tokens"] > 0 and got["offloaded_decodes"] > 0


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp2_tokens_match_tp1(name, port):
    """TP=2 emits TP=1's tokens; the swap totals and per-stream split sum
    to TP=1's where both plan alike."""
    one, two = port[name, 1][0], port[name, 2][0]
    assert two["tokens"] == one["tokens"], name
    if two["plans"] == one["plans"]:
        assert two["transfer_bytes"] == one["transfer_bytes"]
        assert sum(two["bytes_by_stream"].values()) == sum(one["bytes_by_stream"].values())


def test_tp2_logits_record(weights, capsys):
    """Whether TP=2's logits are TP=1's bit for bit on the CPU: recorded,
    not asserted (the tokens are, above)."""
    runs = {}
    for tp in (1, 2):
        runs[tp] = []
        _port(weights, "neo", tp, record=runs[tp])
    a, b = np.stack(runs[1]), np.stack(runs[2])
    assert a.shape == b.shape
    with capsys.disabled():
        print(json.dumps({"tp2_logits_bitwise_equal_tp1": bool(np.array_equal(a, b)),
                          "max_abs_diff": float(np.abs(a - b).max()), "tokens": len(a)}))


def test_traced_tp2_export_validates(port, reference, tmp_path):
    """The traced TP=2 run: per-shard host-attention and copy tracks,
    obs.validate accepts the export, reconcile() passes, and the per-shard
    host-attention tracks are the reference's."""
    _, eng = port["neo-traced", 2]
    tr = eng.tracer
    path = tmp_path / "trace_tp2.json"
    tr.export_chrome(str(path))
    assert validate(str(path), expect_copy=True) == []
    tracks = tr.tracks()
    assert {"hostattn-b0-s0", "hostattn-b0-s1", "copy-out0", "copy-out1"} <= set(tracks)
    ref_shard = [t for t in reference["neo-traced"]["shard_tracks"] if t.startswith("hostattn")]
    assert sorted(t for t in tracks if t.startswith("hostattn") and t.endswith(("-s0", "-s1"))) \
        == ref_shard
    assert reconcile(tr, eng.stats).ok


def test_repeated_shard_devices_are_the_default(weights):
    """An explicit list naming the CPU twice is what a CPU engine takes by
    default."""
    got, _ = _port(weights, "fastdecode", 2, shard_devices=["cpu", "cpu"])
    assert got == _port(weights, "fastdecode", 2)[0]


def test_shard_split_concat_is_unsharded():
    """The per-shard column slices concatenate to the unsharded leaves bit
    for bit; only QKV and the SwiGLU's up-projections are sharded."""
    for tp, cfg in ((2, CFG), (4, CFG.replace(num_kv_heads=4))):
        state = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
        shards = shard_state_dict(state, tp)
        sharded = {n for n in state if gather_tp_spec(n) is not None}
        assert sharded == {n for n in state
                           if n.endswith(("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate",
                                          "mlp.w_up"))}
        for name in sharded:
            assert all(s[name].is_contiguous() for s in shards)
            cat = tp_allgather([s[name] for s in shards], gather_tp_spec(name))
            assert torch.equal(cat, state[name]), name
    assert tp_allgather([state["embed"]], 0) is state["embed"]  # the identity at tp=1


def test_host_views_write_through():
    """Each shard's HostAttention appends through its strided KV-head view
    of the one host pool: the pool sees every write, in its own heads."""
    pool = DualPool(CFG, 4, 8, device="cpu", shard_devices=["cpu", "cpu"])
    rng = np.random.default_rng(0)
    KV, hd = CFG.num_kv_heads, CFG.head_dim
    for s in range(2):
        k_s, v_s = pool.host.kv_head_slice(s, 2)
        assert not k_s.flags["C_CONTIGUOUS"] and k_s.shape[3] == KV // 2
        ha = HostAttention(CFG, k_s, v_s)
        k_new = rng.standard_normal((3, KV // 2, hd)).astype(np.float32)
        v_new = rng.standard_normal((3, KV // 2, hd)).astype(np.float32)
        ha.append_tokens(1, np.arange(3), k_new, v_new, np.array([2, 5, 7]), np.array([0, 3, 9]))
        lo = s * KV // 2
        got_k = pool.host.k[1, [2, 5, 7], [0, 3, 9], lo:lo + KV // 2].numpy()
        got_v = pool.host.v[1, [2, 5, 7], [0, 3, 9], lo:lo + KV // 2].numpy()
        assert np.array_equal(got_k, k_new) and np.array_equal(got_v, v_new)
    assert pool.device.k is None and len(pool.device.shard_k) == 2
    assert pool.device.shard_k[0].shape[3] == KV // 2


@pytest.mark.parametrize("sharded_pool", [False, True], ids=["one-pool", "sharded-pool"])
def test_sharded_transfer_round_trip(sharded_pool):
    """shards=2: swap_out scatters each shard's KV-head slice into the host
    pool, swap_in reassembles it on the device; one job per shard per
    direction, the streams' bytes partition the totals, and hidden_bytes
    covers the whole copy for an all-covering window
    (``tests/test_sharded_engine.py``)."""
    pool = DualPool(CFG, 8, 16, device="cpu",
                    shard_devices=["cpu", "cpu"] if sharded_pool else None)
    te = TransferEngine(pool, shards=2)
    try:
        rng = np.random.default_rng(0)
        req = Request(rid=0, prompt=list(range(PAGE * 2)), max_new_tokens=4)
        req.pages = pool.device.alloc(2)
        req.location = "gpu"
        shape = (pool.device.num_layers, 2, PAGE, CFG.num_kv_heads, CFG.head_dim)
        ref_k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        ref_v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        pool.device.put_pages(req.pages, ref_k, ref_v)

        h = te.swap_out(req)
        te.join([h])
        assert req.location == "cpu" and h._jobs_total == 2
        assert torch.equal(pool.host.read_pages(req.pages)[0], ref_k)
        assert torch.equal(pool.host.read_pages(req.pages)[1], ref_v)
        assert h.hidden_bytes(0.0, 1e18) == h.nbytes

        h2 = te.swap_in(req)
        te.join([h2])
        assert req.location == "gpu"
        k, v = pool.device.read_pages(req.pages)
        assert torch.equal(k, ref_k) and torch.equal(v, ref_v)

        st = te.stats.bytes_by_stream
        assert set(st) == {"out0", "out1", "in0", "in1"}, st
        assert st["out0"] == st["out1"] and st["in0"] == st["in1"]
        assert st["out0"] + st["out1"] == te.stats.bytes_out == h.nbytes
        assert st["in0"] + st["in1"] == te.stats.bytes_in == h2.nbytes
    finally:
        te.close()


def test_transfer_rejects_non_dividing_shards():
    pool = DualPool(CFG, 4, 8, device="cpu")  # 2 kv heads
    with pytest.raises(ValueError):
        TransferEngine(pool, shards=3)
    with pytest.raises(ValueError, match="do not divide"):
        DualPool(CFG, 4, 8, device="cpu", shard_devices=["cpu"] * 3)


def test_engine_refusals():
    """What the reference refuses at tp > 1: more shards than cards (no CPU
    fallback), a tp not dividing the heads, a contiguous family."""
    with pytest.raises(ValueError, match="exceeds the 0 available"):
        mesh.shard_devices(2, torch.device("cuda"))
    with pytest.raises(ValueError, match="needs 2 shard devices"):
        mesh.shard_devices(2, torch.device("cpu"), ["cpu"])
    with pytest.raises(ValueError, match="must divide"):
        NeoEngine(CFG, EngineConfig(tp=4, device_pool_pages=4, host_pool_pages=4),
                  device="cpu")
    with pytest.raises(ValueError, match="paged engine"):
        NeoEngine(get_smoke_config("rwkv6-7b"), EngineConfig(tp=2), device="cpu")


def test_serve_cli_tp2_on_cpu(capsys):
    """``serve --device cpu --tp 2`` serves every request."""
    rc = serve.main(["--device", "cpu", "--smoke", "--tp", "2", "--n", "4",
                     "--device-pages", "16", "--host-pages", "64"])
    out = capsys.readouterr().out
    assert rc == 0 and "tp=2" in out
    summary = json.loads(out[out.index("{"): out.index("scheduler modes:")])
    assert summary["requests"] == 4, summary
