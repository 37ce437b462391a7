"""The port's observability layer (``repro_torch.obs``) against the JAX
package's, at the smoke size (qwen3-0.6b: 4 layers, d_model 128, fp32;
rwkv6-7b's smoke config on the contiguous path).

Four contracts, as in ``tests/test_obs.py``:

1. **Tracing never changes behaviour**: tokens are bitwise the same with
   tracing on and off (``neo``, ``fastdecode``, ``neo`` + plan-ahead and a
   contiguous rwkv6 run).
2. **The timeline is well-formed**: within a track spans nest or are
   disjoint, the ring drops the oldest events, both sinks round-trip, and a
   span and its nested span that end on one float end on one exported
   microsecond value.
3. **The spans carry the truth**: ``reconcile()`` recomputes lane busy
   time, overlap, bubble fraction, swap-hidden bytes and plan-ahead time
   from the spans alone and agrees with the port's ``EngineStats`` at the
   reference's ``rtol = atol = 1e-6`` (bytes exact).
4. **The trace is the reference's up to time**: the same config, prompts and
   bridged weights, with the perf model frozen (``ewma_alpha=0``), give per
   track the same multiset of events (phase, name, request id, and args
   without their times) and the same tokens.

Engines are closed in teardown; weights come from the reference's
``model.init(jax.random.key(7))`` through ``repro_torch.models.bridge``.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.obs.tracer import SpanTracer as RefSpanTracer  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import EngineStats, NeoEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402
from repro_torch.obs import ReconcileReport, SpanTracer, reconcile  # noqa: E402
from repro_torch.obs import validate as port_validate  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-0.6b", "rwkv6-7b")


@pytest.fixture(scope="module")
def weights():
    """Per arch: (reference config, reference params, port config, state dict)."""
    out = {}
    for arch in ARCHS:
        cfg_ref = ref_smoke(arch)
        params = ref_get_model(cfg_ref).init(jax.random.key(7))
        cfg = get_smoke_config(arch)
        out[arch] = (cfg_ref, params, cfg,
                     params_from_reference(jax.tree.map(np.asarray, params), cfg))
    return out


@pytest.fixture
def build(weights):
    made = []

    def make(arch="qwen3-0.6b", *, side="port", tracing=True, policy="neo", device=7,
             host=96, max_batch_tokens=64, **kw):
        cfg_ref, params, cfg, state = weights[arch]
        kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, device_pool_pages=device,
                  host_pool_pages=host, max_batch_tokens=max_batch_tokens, policy=policy,
                  tracing=tracing, **kw)
        if side == "ref":
            eng = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
        else:
            eng = NeoEngine(cfg, EngineConfig(**kw), params=state, device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompts(seed, sizes, repeat=0):
    """Seeded prompts; with ``repeat`` each opens with one 8-token base
    repeated that many times (repetition the n-gram drafter can use)."""
    rng = np.random.default_rng(seed)
    base = list(map(int, rng.integers(1, 500, size=8))) * repeat if repeat else []
    return [base + list(map(int, rng.integers(1, 500, size=n))) for n in sizes]


def _run(eng, prompts, n=8, max_iters=400):
    rids = [eng.submit(p, n) for p in prompts]
    done = eng.run_until_done(max_iters)
    return [done[r] for r in rids]


def _assert_ok(rep: ReconcileReport) -> None:
    assert rep.ok, f"reconcile failed: {rep.failed()}\n{rep.summary()}"
    assert rep.checks["swap_hidden_bytes"]["stats"] == rep.checks["swap_hidden_bytes"]["traced"]


# The runs the contracts are checked on: engine options and prompt lengths.
# "neo" runs with a device pool so tight that swaps and mixed plans occur;
# the contiguous run prefills every request in its first step (the
# reference's contiguous path decodes a request prefilled beside decoding
# rows on token 0, ROADMAP queue 3).
RUNS = {
    "neo": dict(kw=dict(policy="neo", planahead=False), sizes=(7, 19, 26, 12)),
    "fastdecode": dict(kw=dict(policy="fastdecode", device=48, host=256,
                               max_batch_tokens=256), sizes=(7, 19, 26, 12)),
    "neo-planahead": dict(kw=dict(policy="neo", planahead=True), sizes=(7, 19, 26, 12)),
    # speculative decoding: verify passes on the unaudited "spec" track,
    # host pseudo-rows on the tight pool
    "neo-spec": dict(kw=dict(policy="neo", planahead=True, spec_decode=True),
                     sizes=(7, 19, 26, 12), repeat=3),
    "rwkv6-contiguous": dict(kw=dict(arch="rwkv6-7b", pipeline=False, max_batch_tokens=128),
                             sizes=(9, 14, 21)),
}


# ---------------------------------------------------------------------------
# ring buffer and sinks (the tracer alone)
# ---------------------------------------------------------------------------


def test_ring_overflow_drops_oldest_never_blocks():
    tr = SpanTracer(capacity=8)
    for i in range(20):
        tr.emit("t", f"s{i}", float(i), float(i) + 0.5)
    assert tr.total == 20 and tr.dropped == 12
    assert [e.name for e in tr.events()] == [f"s{i}" for i in range(12, 20)]


def test_ring_no_overflow_keeps_order():
    tr = SpanTracer(capacity=16)
    for i in range(5):
        tr.emit("t", f"s{i}", float(i), float(i) + 0.5)
    assert tr.dropped == 0
    assert [e.name for e in tr.events()] == [f"s{i}" for i in range(5)]


def test_reconcile_refuses_wrapped_ring():
    tr = SpanTracer(capacity=2)
    for i in range(5):
        tr.emit("t", "s", float(i), float(i) + 0.5)
    rep = reconcile(tr, EngineStats())
    assert not rep.ok and rep.dropped == 3 and rep.notes


def test_export_chrome_shape(tmp_path):
    tr = SpanTracer()
    tr.emit("engine", "step", 1.0, 2.0, {"iter": 0})
    tr.emit("host0", "lane", 1.2, 1.8, {"iter": 0})
    tr.instant("engine", "plan_adopt", {"dur": 0.01})
    tr.counter("queues", {"waiting": 3, "running": 2})
    tr.async_begin(7, "req", t=1.0, args={"prompt_len": 4})
    tr.async_end(7, "req", t=2.0, args={"outcome": "finished"})
    path = str(tmp_path / "trace.json")
    doc = tr.export_chrome(path)
    assert json.load(open(path)) == doc
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {"engine", "host0"} <= {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert any(e["name"] == "process_name" for e in meta)
    spans = [e for e in evs if e["ph"] == "X"]
    step = next(e for e in spans if e["name"] == "step")
    assert step["ts"] == pytest.approx(1.0e6) and step["dur"] == pytest.approx(1.0e6)
    counters = [e for e in evs if e["ph"] == "C"]
    assert counters and counters[0]["args"] == {"waiting": 3, "running": 2}
    assert {a["id"] for a in evs if a["ph"] in ("b", "e")} == {"7"}
    assert doc["otherData"] == {"tracer": "repro_torch.obs", "events_recorded": 6,
                                "events_dropped": 0}


def test_export_counters_jsonl(tmp_path):
    tr = SpanTracer()
    tr.counter("queues", {"waiting": 1}, t=0.5)
    tr.counter("pool_free", {"device": 9, "host": 2}, t=0.6)
    tr.emit("engine", "step", 0.0, 1.0)  # not a counter: excluded
    path = str(tmp_path / "c.jsonl")
    assert tr.export_counters_jsonl(path) == 2
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert lines == [{"t": 0.5, "name": "queues", "values": {"waiting": 1}},
                     {"t": 0.6, "name": "pool_free", "values": {"device": 9, "host": 2}}]


def test_export_nested_spans_end_on_one_float(tmp_path):
    """A span and its nested span that end on one float, a million seconds
    into the clock: the port's export gives both the end ``t1 * 1e6``
    exactly, so no pair straddles and the validator passes.  The reference's
    ``(t1 - t0) * 1e6`` straddles by an ulp on some of the same pairs."""
    rng = np.random.default_rng(8)
    port, ref = SpanTracer(), RefSpanTracer()
    t = 1e6
    for _ in range(200):
        t0 = t + float(rng.random()) * 1e-3
        t_in = t0 + float(rng.random()) * 1e-3
        t1 = t_in + float(rng.random()) * 1e-3
        for tr in (port, ref):
            tr.emit("host0", "lane", t0, t1)
            tr.emit("host0", "compute", t_in, t1)
            tr.emit("planner", "plan", t0, t1)
            tr.async_begin(0, "req", t=t0)
            tr.async_end(0, "req", t=t1)
        t = t1 + 1e-3

    def ends(doc):
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] != "plan"]
        return [(o["ts"] + o["dur"], i["ts"] + i["dur"]) for o, i in zip(spans[::2], spans[1::2])]

    port_ends = ends(port.export_chrome())
    assert all(o == i for o, i in port_ends)
    assert [o for o, _ in port_ends] == [e.t1 * 1e6 for e in port.events()
                                         if e.ph == "X" and e.name == "lane"]
    assert any(i > o for o, i in ends(ref.export_chrome()))  # the reference's ulp straddle
    path = str(tmp_path / "nested.json")
    port.export_chrome(path)
    assert port_validate.validate(path) == []


# ---------------------------------------------------------------------------
# tracing on = tracing off, and reconcile() on the traced run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(RUNS))
def test_tracing_bitwise_identity(run, build):
    kw = dict(RUNS[run]["kw"])
    prompts = _prompts(40, RUNS[run]["sizes"], RUNS[run].get("repeat", 0))
    outs = {}
    for tracing in (False, True):
        eng = build(tracing=tracing, **kw)
        outs[tracing] = _run(eng, prompts)
        assert (eng.tracer is not None) == tracing
    assert outs[True] == outs[False], f"{run}: tracing changed the tokens"
    assert eng.tracer.total > 0 and eng.tracer.dropped == 0
    _assert_ok(reconcile(eng.tracer, eng.stats))


# ---------------------------------------------------------------------------
# well-formedness and coverage
# ---------------------------------------------------------------------------


def _assert_well_formed(tracer):
    by_track = {}
    for e in tracer.events():
        if e.ph == "X":
            assert e.t1 >= e.t0, f"negative span {e.track}/{e.name}"
            by_track.setdefault(e.track, []).append(e)
    assert by_track, "no spans recorded"
    for track, evs in by_track.items():
        evs.sort(key=lambda e: (e.t0, -e.t1))  # enclosing first; a stack proves nesting
        stack = []
        for e in evs:
            while stack and stack[-1].t1 <= e.t0:
                stack.pop()
            if stack:
                assert e.t1 <= stack[-1].t1, (
                    f"{track}: {e.name} [{e.t0},{e.t1}] straddles "
                    f"{stack[-1].name} [{stack[-1].t0},{stack[-1].t1}]")
            stack.append(e)
    return by_track


def test_span_well_formedness_and_coverage(build):
    """One traced mixed run: every track's spans nest or are disjoint, and
    the tracks the instrumentation promises show up."""
    eng = build(policy="fastdecode", device=48, host=256, max_batch_tokens=256,
                planahead=True)
    _run(eng, _prompts(41, (7, 19, 26, 12, 9, 15)))
    tracer, stats = eng.tracer, eng.stats
    by_track = _assert_well_formed(tracer)
    assert {"engine", "sched", "device", "planner"} <= set(by_track)
    assert any(t.startswith("host") and not t.startswith("hostattn") for t in by_track)
    assert any(t.startswith("hostattn") for t in by_track)
    steps = [e for e in by_track["engine"] if e.name == "step"]
    assert len(steps) == stats.iterations
    assert sorted(e.args["iter"] for e in steps) == list(range(1, stats.iterations + 1))
    # every host lane span holds its nested join and compute spans
    lanes = [e for t, evs in by_track.items() if t.startswith("host") and
             not t.startswith("hostattn") for e in evs]
    assert {e.name for e in lanes} >= {"lane", "compute"}
    evs = tracer.events()
    assert len([e for e in evs if e.ph == "b" and e.name == "req"]) == 6
    assert len([e for e in evs if e.ph == "e" and e.name == "req"]) == 6


# ---------------------------------------------------------------------------
# reconcile(): the spans reproduce EngineStats
# ---------------------------------------------------------------------------


def test_reconcile_fastdecode(build):
    eng = build(policy="fastdecode", device=48, host=256, max_batch_tokens=256)
    _run(eng, _prompts(42, (7, 19, 26, 12)))
    rep = reconcile(eng.tracer, eng.stats)
    _assert_ok(rep)
    assert any(k.startswith("lane_busy[host") for k in rep.checks)


def test_reconcile_mixed_neo_tight_pool(build):
    """Tight device pool: swaps and mixed plans, so the swap-hidden bytes and
    overlap formulas run over real copy traffic."""
    eng = build(policy="neo", planahead=True)
    _run(eng, _prompts(43, (7, 19, 26, 12)))
    rep = reconcile(eng.tracer, eng.stats)
    _assert_ok(rep)
    assert eng.stats.swap_out_bytes > 0 and rep.checks["swap_hidden_bytes"]["traced"] > 0
    assert "bubble_fraction" in rep.checks
    assert any(e.track.startswith("copy-") for e in eng.tracer.events())


def test_reconcile_planahead_adoptions(build):
    eng = build(policy="neo", planahead=True)
    _run(eng, _prompts(44, (7, 19, 26, 12)))
    _assert_ok(reconcile(eng.tracer, eng.stats))
    adopted = [e for e in eng.tracer.events() if e.ph == "i" and e.name == "plan_adopt"]
    assert eng.stats.planahead_hits > 0 and len(adopted) == eng.stats.planahead_hits


def test_reconcile_contiguous_rwkv6(build):
    """The contiguous path's prefill and serial lane windows are spanned, so
    reconcile() holds device busy time there too (the reference's contiguous
    path records no lane windows and emits no device span)."""
    eng = build("rwkv6-7b", pipeline=False, max_batch_tokens=128)
    _run(eng, _prompts(45, (9, 14, 21)))
    rep = reconcile(eng.tracer, eng.stats)
    _assert_ok(rep)
    assert rep.checks["lane_busy[prefill]"]["traced"] > 0
    assert rep.checks["lane_busy[serial]"]["traced"] > 0
    assert rep.checks["device_busy_time"]["stats"] == pytest.approx(
        eng.stats.lane_busy_time["prefill"] + eng.stats.lane_busy_time["serial"])


def test_trace_reject_and_cancel_events(build):
    eng = build(device=16, host=32, max_waiting=1)
    p = _prompts(46, (6, 6, 6))
    first = eng.offer(p[0], 4)
    assert first is not None and eng.offer(p[1], 4) is None
    victim = eng.submit(p[2], 8)
    eng.step()
    assert eng.cancel(victim)
    eng.run_until_done(100)
    evs = eng.tracer.events()
    rejects = [e for e in evs if e.ph == "i" and e.name == "reject"]
    assert len(rejects) == 1 and rejects[0].args["reason"] == "max_waiting"
    ends = {e.rid: e.args["outcome"] for e in evs if e.ph == "e" and e.name == "req"}
    assert ends == {first: "finished", victim: "cancelled"}
    _assert_ok(reconcile(eng.tracer, eng.stats))


# ---------------------------------------------------------------------------
# the differential gate: the port's trace is the reference's up to time
# ---------------------------------------------------------------------------

# args that hold wall-clock readings (``dur`` of the plan spans and the
# adopt instant, ``host_busy`` of an inline lane): compared by presence only
TIME_ARGS = ("dur", "host_busy")


def _shape(events, skip_tracks=()):
    """Per track, the multiset of (phase, name, request id, args without
    their times)."""
    out = collections.defaultdict(collections.Counter)
    for e in events:
        if e.track in skip_tracks:
            continue
        args = tuple(sorted((k, "<time>" if k in TIME_ARGS else v)
                            for k, v in (e.args or {}).items()))
        out[e.track][(e.ph, e.name, e.rid, args)] += 1
    return dict(out)


@pytest.mark.parametrize("run", ["neo-planahead", "fastdecode", "rwkv6-contiguous",
                                 "neo-spec"])
def test_trace_matches_reference_up_to_time(run, build):
    """Every event the reference's engine, executor, scheduler and transfer
    engine emit, the port emits on the same track with the same name,
    request id and args (iterations, rows, bytes, modes, inline flags,
    counters, tokens).  No event count here depends on the clock: with the
    perf model frozen the plans, and with them plan-ahead's skips, hits and
    replans, follow from the inputs alone.  On the contiguous path the
    ``device`` track is left out: only the port records lane windows there."""
    kw = dict(RUNS[run]["kw"])
    prompts = _prompts(47, RUNS[run]["sizes"], RUNS[run].get("repeat", 0))
    engines = {side: build(side=side, **kw) for side in ("ref", "port")}
    outs = {side: _run(eng, prompts) for side, eng in engines.items()}
    assert outs["port"] == outs["ref"]
    for eng in engines.values():
        # the last step's plan-ahead may still be planning on its thread:
        # let it emit its spans before the timelines are compared
        if getattr(eng, "_spec", None) is not None:
            eng._spec[3].result(timeout=600)
    skip = ("device",) if run == "rwkv6-contiguous" else ()
    ref_shape = _shape(engines["ref"].tracer.events(), skip)
    port_shape = _shape(engines["port"].tracer.events(), skip)
    assert sorted(port_shape) == sorted(ref_shape)
    for track in ref_shape:
        assert port_shape[track] == ref_shape[track], track
    if run == "rwkv6-contiguous":
        assert "device" in _shape(engines["port"].tracer.events())
    if run == "neo-spec":
        assert port_shape["spec"] and engines["port"].stats.spec_steps > 0
    assert engines["port"].tracer.dropped == engines["ref"].tracer.dropped == 0


# ---------------------------------------------------------------------------
# the validator
# ---------------------------------------------------------------------------


def _chrome_doc(extra_tracks):
    """A minimal valid trace: device and planner rows, one request, plus
    ``extra_tracks`` as {name: [(ts, dur, name), ...]}."""
    tracks = {"device": [(0, 10, "decode")], "planner": [(0, 2, "plan")]}
    tracks.update(extra_tracks)
    evs = []
    for tid, (track, spans) in enumerate(sorted(tracks.items()), start=1):
        evs.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                    "args": {"name": track}})
        for ts, dur, name in spans:
            evs.append({"ph": "X", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
                        "name": name, "args": {}})
    evs.append({"ph": "b", "cat": "req", "name": "req", "id": 1, "pid": 1, "tid": 1, "ts": 0})
    evs.append({"ph": "e", "cat": "req", "name": "req", "id": 1, "pid": 1, "tid": 1, "ts": 10})
    return {"traceEvents": evs, "otherData": {"events_dropped": 0}}


def _validate_doc(tmp_path, doc, **kw):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps(doc))
    return port_validate.validate(str(p), **kw)


def test_validate_accepts_wellformed_tp2_shard_tracks(tmp_path):
    doc = _chrome_doc({
        "hostattn-b0-s0": [(0, 4, "layer0"), (1, 2, "attend"), (5, 3, "layer1")],
        "hostattn-b0-s1": [(0, 4, "layer0"), (5, 3, "layer1")],
        "hostattn-prefix-s0": [(20, 2, "prefix")],
        "hostattn-prefix-s1": [(20, 2, "prefix")],
    })
    assert _validate_doc(tmp_path, doc) == []


def test_validate_flags_two_writers_on_one_shard_track(tmp_path):
    doc = _chrome_doc({"hostattn-b0-s0": [(0, 5, "layer0"), (3, 6, "layer0")],
                       "hostattn-b0-s1": [(0, 4, "layer0")]})
    fails = _validate_doc(tmp_path, doc)
    assert any("hostattn-b0-s0" in f and "single-writer" in f for f in fails)


def test_validate_flags_overlap_on_unsharded_track_too(tmp_path):
    fails = _validate_doc(tmp_path, _chrome_doc({"copy-out": [(0, 5, "out"), (4, 4, "out")]}))
    assert any("copy-out" in f and "single-writer" in f for f in fails)


def test_validate_flags_missing_expectations(tmp_path):
    fails = _validate_doc(tmp_path, _chrome_doc({}), expect_host_lane=True, expect_copy=True,
                          min_adopts=1)
    assert len(fails) == 3 and any("copy-stream" in f for f in fails)


@pytest.mark.parametrize("case,flags", [
    ("fastdecode-planahead", ["--expect-host-lane", "--min-adopts", "1"]),
    ("neo-tight-pool", ["--expect-copy"]),
    ("neo-spec", ["--expect-copy"]),
])
def test_validate_accepts_port_exports(case, flags, build, tmp_path, capsys):
    if case == "neo-tight-pool":
        eng = build(policy="neo")
    elif case == "neo-spec":
        eng = build(policy="neo", spec_decode=True)
    else:
        eng = build(policy="fastdecode", device=48, host=256, max_batch_tokens=256,
                    planahead=True)
    _run(eng, _prompts(48, (7, 19, 26, 12), repeat=3 if case == "neo-spec" else 0))
    if case == "neo-spec":
        assert any(e.track == "spec" and e.name == "verify" for e in eng.tracer.events())
    path = str(tmp_path / f"{case}.json")
    eng.tracer.export_chrome(path)
    assert port_validate.main([path, *flags]) == 0
    assert "[obs.validate] OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_trace_smoke_exits_zero_and_validates(tmp_path):
    """The reference CI's trace-smoke arguments, through ``python -m``."""
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--trace", "multiturn", "--n", "12", "--rate", "4", "--policy", "neo",
         "--arrivals", "poisson", "--device-pages", "20", "--host-pages", "256",
         "--trace-out", str(trace), "--require-reconcile"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert '"reconcile": {' in out.stdout and (tmp_path / "trace.counters.jsonl").exists()
    assert port_validate.validate(str(trace)) == []
    doc = json.loads(trace.read_text())
    assert doc["otherData"]["tracer"] == "repro_torch.obs"


def test_serve_require_reconcile_fails_on_disagreement(tmp_path, monkeypatch, capsys):
    """``--require-reconcile`` turns a failed audit into exit code 1."""
    def failing(tracer, stats):
        rep = ReconcileReport()
        rep.add("device_busy_time", 1.0, 2.0, False)
        return rep

    monkeypatch.setattr(serve, "reconcile", failing)
    counters = tmp_path / "c.jsonl"
    rc = serve.main(["--smoke", "--device", "cpu", "--n", "2", "--device-pages", "16",
                     "--host-pages", "64", "--trace-out", str(tmp_path / "t.json"),
                     "--counters-out", str(counters), "--require-reconcile"])
    assert rc == 1 and counters.exists()
    assert "disagrees with EngineStats" in capsys.readouterr().out


def test_overhead_tool_runs_on_cpu(capsys):
    """``python -m repro_torch.obs.overhead`` at the smoke size on the CPU:
    one round in turns, traced tokens equal to untraced, reconcile ok."""
    from repro_torch.obs import overhead

    assert overhead.main(["--smoke", "--device", "cpu", "--rounds", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    runs = [json.loads(x)["run"] for x in lines if x.startswith('{"run"')]
    assert [r["traced"] for r in runs] == [False, True, True, False]
    summary = json.loads(lines[-1])["obs_overhead"]
    assert summary["device"] == "cpu" and summary["events_per_traced_run"] > 0
    assert summary["emit_us"] > 0
