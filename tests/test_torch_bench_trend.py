"""The port's bench-trend gate (``repro_torch.benchmarks.bench_trend``) and
tensor-parallel A/B (``.engine_sharded``) against the JAX package's
(``benchmarks/bench_trend.py``, ``benchmarks/engine_sharded.py``), on the
CPU.

* ``gate``: on the same summaries (the reference's checked-in baseline,
  and that baseline with one gate broken at a time) the port counts the
  reference's failures; the schema and tolerances are the reference's, and
  the port's copy of the smoke baseline is the reference's byte for byte.
* ``engine_sharded``: TP=1 against TP=2 on the swap-heavy smoke trace.  The
  reference runs it in a subprocess with fake XLA devices; its child's
  ``EngineConfig`` is replaced, in the child's source for the test only, by
  one with the perf model frozen and the H100 profile (the reference's file
  stays as it is), and its output is captured.  The port runs in this
  process on two CPU shards with the reference's weights (the child's
  engine draws ``init(key(0))``): the gates, byte totals and per-stream
  split, and every request's tokens at TP=1 and TP=2, are the reference's.
* ``collect`` and ``main`` with the sections stubbed: the summary's
  fields, the bitwise recheck in another dtype, the baseline handling.
  (``collect`` itself runs end to end on the card, ``chip_smoke.py``'s
  phase 3h, and on the CPU with ``--smoke --device cpu``; its sections are
  held to the reference's in ``tests/test_torch_benchmarks.py``.)
"""

import copy
import json
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks import bench_trend as ref_bt  # noqa: E402
from benchmarks import engine_sharded as ref_sh  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.benchmarks import bench_trend, engine_sharded  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "qwen3-0.6b"
SHARDED_N = 4  # requests of the TP A/B (the reference's 6); 4 still swap


@pytest.fixture(scope="module")
def baseline():
    with open(REPO / "benchmarks" / "BENCH_baseline.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def state():
    """The reference's ``init(key(0))`` smoke weights as the port's."""
    params = ref_get_model(ref_smoke(ARCH)).init(jax.random.key(0))
    return params_from_reference(jax.tree.map(np.asarray, params), get_smoke_config(ARCH))


def test_baseline_copy_is_the_references():
    ref = (REPO / "benchmarks" / "BENCH_baseline.json").read_bytes()
    assert Path(bench_trend.BASELINE_PATH).read_bytes() == ref


def test_schema_and_tolerances_are_the_references():
    assert bench_trend.SCHEMA == ref_bt.SCHEMA == "neo-bench-trend/v6"
    for name in ("BUBBLE_TOL", "HIT_RATE_TOL", "TRACING_OVERHEAD_TOL"):
        assert getattr(bench_trend, name) == getattr(ref_bt, name) == 0.05


def test_h100_baseline_names_its_card(baseline):
    """The card's baseline has the smoke baseline's schema (every section
    and key), names the card and its power limit, and passes its own gate."""
    with open(bench_trend.H100_BASELINE_PATH) as f:
        h100 = json.load(f)
    assert h100["schema"] == baseline["schema"]
    for sec, fields in baseline.items():
        if isinstance(fields, dict):
            assert set(fields) <= set(h100[sec]), sec
    assert "H100" in h100["card"] and " W" in h100["card"]
    assert bench_trend.gate(h100, h100) == 0


# one summary per gate, the baseline with that gate broken: (section, key,
# value); the value None deletes the key (the reference reads it with .get)
BROKEN = {
    "bubble_regressed": ("engine", "bubble_fraction", 0.033 + 0.0501),
    "no_microbatched_steps": ("engine", "microbatched_steps", 0),
    "no_borrowed_lane_steps": ("engine", "borrowed_lane_steps", 0),
    "hit_rate_regressed": ("prefix_cache", "hit_rate", 0.714 - 0.0501),
    "no_host_served_tokens": ("prefix_cache", "host_served_hit_tokens", 0),
    "no_inplace_host_hits": ("prefix_cache", "inplace_host_hits", None),
    "no_planahead_hits": ("serving", "planahead_hits", 0),
    "sustained_diverged": ("serving", "bitwise_identical", False),
    "tp2_diverged": ("sharded", "tp2_bitwise_ok", False),
    "swap_bytes_differ": ("sharded", "swap_bytes_equal", None),
    "stream_split_inexact": ("sharded", "stream_split_exact", False),
    "spec_diverged": ("spec", "bitwise_ok", False),
    "spec_accepted_none": ("spec", "oracle_accepted", 0),
    "spec_hist_empty": ("spec", "oracle_accept_len_hist", {"0": 3}),
    "spec_no_win": ("spec", "oracle_speedup", 1.0),
    "tracing_overhead": ("obs", "tracing_overhead", 0.0501),
    "reconcile_failed": ("obs", "reconcile_ok", False),
    "two_at_once": ("obs", "reconcile_ok", False),
    "within_tolerance": ("engine", "bubble_fraction", 0.033 + 0.05),
}


@pytest.mark.parametrize("case", ["baseline"] + list(BROKEN))
def test_gate_counts_the_references_failures(baseline, case, capsys):
    summary = copy.deepcopy(baseline)
    if case != "baseline":
        sec, key, value = BROKEN[case]
        if value is None:
            del summary[sec][key]
        else:
            summary[sec][key] = value
        if case == "two_at_once":
            summary["spec"]["oracle_speedup"] = 0.5
    want = ref_bt.gate(summary, baseline)
    ref_out = capsys.readouterr().out
    got = bench_trend.gate(summary, baseline)
    assert got == want
    assert capsys.readouterr().out == ref_out  # the reference's messages
    expect = {"baseline": 0, "within_tolerance": 0, "two_at_once": 2}.get(case, 1)
    assert got == expect


@pytest.fixture(scope="module")
def sharded(state):
    """(the reference's gates and its child's raw result, the port's)."""
    child = ref_sh._CHILD.replace(
        "from repro.config import EngineConfig\n",
        "import functools\nfrom repro.config import EngineConfig as _EngineConfig\n"
        "EngineConfig = functools.partial(_EngineConfig, ewma_alpha=0.0, "
        "hw_profile='h100_sxm')\n")
    assert child != ref_sh._CHILD
    seen = []

    def run(*a, **k):
        proc = subprocess.run(*a, **k)
        seen.append(proc.stdout)
        return proc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_sh, "_CHILD", child)
        mp.setattr(ref_sh, "subprocess", types.SimpleNamespace(run=run))
        ref = ref_sh.run(SHARDED_N)
    line = [ln for ln in seen[-1].splitlines() if ln.startswith("RESULT ")][-1]
    ref_raw = json.loads(line[len("RESULT "):])
    port = engine_sharded.run(SHARDED_N, smoke=True, device="cpu", params=state,
                              ewma_alpha=0.0)
    return ref, ref_raw, port


def test_sharded_matches_reference(sharded):
    ref, ref_raw, port = sharded
    keys = [k for k in ref if not k.endswith("_tok_s")]
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert set(port) == set(ref) | {"outputs"}
    assert port["tp2_bitwise_ok"] and port["swap_bytes_equal"] and port["stream_split_exact"]
    assert port["bytes_out"] > 0 and set(port["tp2_copy_streams"]) >= {"out0", "out1"}
    assert engine_sharded.check(dict(port)) == 0


def test_sharded_tokens_match_reference(sharded):
    """Every request's tokens at TP=1 and at TP=2 are the reference's."""
    _, ref_raw, port = sharded
    for tp in ("tp1", "tp2"):
        ref_out = {int(k): v for k, v in ref_raw[tp]["outputs"].items()}
        got = {int(k): v for k, v in port["outputs"][tp].items()}
        assert got == ref_out and sum(map(len, got.values())) == SHARDED_N * 12
        assert ref_raw[tp]["bytes_by_stream"] == (port["tp2_copy_streams"] if tp == "tp2"
                                                  else ref_raw[tp]["bytes_by_stream"])


def test_tp_devices_on_the_cpu_and_one_card(monkeypatch):
    """The shards: tp x the CPU; on a machine with fewer cards than tp, tp
    x the one card; with enough cards, one card each."""
    cpu = torch.device("cpu")
    assert engine_sharded.tp_devices(2, cpu) == [cpu, cpu]
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert engine_sharded.tp_devices(2, cuda) == [cuda, cuda]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert engine_sharded.tp_devices(2, cuda) == [torch.device("cuda", 0),
                                                   torch.device("cuda", 1)]


def test_main_refuses_without_a_baseline(monkeypatch, tmp_path, capsys):
    """``main`` writes the summary under build/ and, without a baseline at
    ``--baseline``, fails as the reference's does (collect stubbed)."""
    monkeypatch.setattr(bench_trend, "collect", lambda n, **k: (0, {"schema": "x"}))
    monkeypatch.setattr(bench_trend, "SUMMARY_PATH", str(tmp_path / "BENCH_engine.json"))
    missing = str(tmp_path / "none.json")
    assert bench_trend.main(["--smoke", "--device", "cpu", "--baseline", missing]) == 1
    assert "no baseline at" in capsys.readouterr().out
    assert json.loads((tmp_path / "BENCH_engine.json").read_text()) == {"schema": "x"}
    assert bench_trend.main(["--smoke", "--device", "cpu", "--baseline", missing,
                             "--write-baseline"]) == 0
    assert json.loads(Path(missing).read_text()) == {"schema": "x"}
    monkeypatch.setattr(bench_trend, "collect", lambda n, **k: (1, {"schema": "x"}))
    assert bench_trend.main(["--smoke", "--device", "cpu", "--baseline", missing]) == 1


@pytest.fixture
def stubbed_sections(monkeypatch):
    """``collect``'s sections replaced by stubs that record the options each
    run receives (``seen``: one dict per run, with its section's name); in
    the model's dtype the n-gram drafter and the prefix cache change a
    token, in float32 they do not."""
    from repro_torch.benchmarks import engine_real, prefix_cache
    from repro_torch.launch import serve

    seen = []

    def spec(n, outputs=None, dtype=None, **k):
        seen.append(dict(k, dtype=dtype, section="spec"))
        ok = dtype == "float32"
        (outputs if outputs is not None else {}).update(off={0: [1, 2]}, ngram={0: [1, 2] if ok else [1, 3]}, oracle={0: [1, 2]})
        run = {"accepted_tokens": 2, "accept_len_hist": {"1": 1}, "token_throughput": 1.0,
               "drafted_tokens": 2, "spec_steps": 1}
        return 0 if ok else 1, {"spec_off": run, "spec_ngram": run, "spec_oracle": run,
                                "spec_gates": {"bitwise_ok": ok, "oracle_speedup": 2.0}}

    def prefix(n, outputs=None, dtype=None, **k):
        seen.append(dict(k, dtype=dtype, section="prefix_cache"))
        ok = dtype == "float32"
        (outputs if outputs is not None else {}).update(cache_off={0: [1]}, cache_on={0: [1 if ok else 2]},
                       hs_cache_off={0: [1]}, hs_cache_on={0: [1]})
        run = {"hit_rate": 0.7, "token_throughput": 1.0, "host_served_hit_tokens": 5,
               "inplace_host_hits": 1, "host_hit_pcie_bytes": 0, "promoted": 0}
        return 0 if ok else 1, {"cache_on": run, "hs_cache_on": run, "prefill_reduction": 3.0,
                                "hs_token_granular_extra_hit_tokens": 4,
                                "outputs_identical": ok, "hs_outputs_identical": True}

    def sustained(outputs=None, dtype=None, **k):
        seen.append(dict(k, dtype=dtype, section="sustained"))
        (outputs if outputs is not None else {}).update(closed={0: [1, 2]}, open={0: [1, 2]})
        loop = {"goodput_rps": 1.0, "ttft_p99_ms": 1.0, "tpot_p99_ms": 1.0,
                "planahead_hits": 3, "planahead_replans": 0, "planahead_hidden_s": 0.0}
        return {"closed": loop, "open": loop, "gates": {"bitwise_identical": True}}

    def recorded(name, result):
        def stub(*a, **k):
            seen.append(dict(k, section=name))
            return result
        return stub

    fd = {"token_throughput": 1.0, "bubble_fraction": 0.0, "microbatched_steps": 1,
          "borrowed_lane_steps": 1, "lane_count_steps": {}, "reconcile_ok": True,
          "trace_events": 1, "trace_dropped": 0, "tracing_overhead": 0.0}
    monkeypatch.setattr(engine_real, "run", recorded("fastdecode", (fd, {0: [1]})))
    monkeypatch.setattr(engine_real, "run_microbatch_section", recorded("microbatch", (
        0, {"fastdecode_mb_on": fd, "fastdecode_mb_off": fd})))
    monkeypatch.setattr(engine_real, "run_mixed_lane_section", recorded("mixed_lane", (
        0, {"mixed_pipelined": fd})))
    monkeypatch.setattr(engine_real, "run_obs_section", recorded("obs", (
        0, {"obs_tracing_off": fd, "obs_tracing_on": fd})))
    monkeypatch.setattr(engine_real, "run_spec_section", spec)
    monkeypatch.setattr(engine_real, "merge_save", lambda d: None)
    monkeypatch.setattr(prefix_cache, "run_section", prefix)
    monkeypatch.setattr(serve, "run_sustained", sustained)
    monkeypatch.setattr(engine_sharded, "run", lambda **k: seen.append(
        dict(k, section="sharded")) or {
        "tp2_bitwise_ok": True, "swap_bytes_equal": True, "stream_split_exact": True,
        "bytes_out": 1, "bytes_in": 0, "tp2_copy_streams": {"out0": 1, "out1": 0},
        "tp1_tok_s": 1.0, "tp2_tok_s": 1.0, "outputs": {}})
    import repro_torch.benchmarks.common as common
    monkeypatch.setattr(common, "save_json", lambda name, data: None)
    return seen


def test_recheck_replaces_the_bitwise_verdicts(stubbed_sections):
    """With ``bitwise_dtype`` other than the model's, the prefix and
    sustained claims come from re-runs in it (at ``recheck_layers``), the
    spec claim stays the model dtype's, every model-dtype token match is
    recorded, and the verdicts are recomputed (sections stubbed)."""
    seen = stubbed_sections
    rc, summary = bench_trend.collect(4, bitwise_dtype="float32", recheck_layers=2,
                                      smoke=True, dtype="bfloat16", device="cpu")
    rec = summary["bitwise_record"]
    # the prefix claim comes from the fp32 re-run; the spec claim stays bf16's
    assert rc == 1 and not summary["spec"]["bitwise_ok"]
    assert summary["serving"]["bitwise_identical"]
    assert rec["spec_ngram_vs_off"] == [1, 2] and rec["prefix_cache_on_vs_off"] == [0, 1]
    assert rec["model_dtype_verdicts"]["prefix_outputs_identical"] is False
    assert rec["asserted_in"] == "float32" and rec["recheck_layers"] == 2
    assert rec["model_dtype"] == "bfloat16"
    assert bench_trend.gate(summary, summary) == 1  # the spec claim, in bf16
    assert [c["layers"] for c in seen if c["dtype"] == "float32"] == [2, 2]


@pytest.mark.parametrize("smoke", [None, True])
def test_collect_passes_each_section_its_model(stubbed_sections, smoke):
    """Every section, the sustained A/B and the re-runs included, serves the
    model ``collect`` was given: full width unless ``smoke`` is given
    (``run_sustained`` alone defaults to the smoke model).  Only the spec
    section takes ``spec_ewma_alpha`` and ``spec_host_threads`` (defaults:
    the perf model live, one thread, the reference's); the others keep the
    caller's ``ewma_alpha`` and no thread count.  A fastdecode run handed
    in is not run again."""
    seen = stubbed_sections
    extra = {} if smoke is None else {"smoke": smoke}
    bench_trend.collect(4, bitwise_dtype="float32", recheck_layers=2, dtype="bfloat16",
                        device="cpu", ewma_alpha=0.0, **extra)
    sections = {c["section"] for c in seen}
    assert sections == {"fastdecode", "microbatch", "mixed_lane", "obs", "spec",
                        "prefix_cache", "sharded", "sustained"}
    assert all(c["smoke"] is bool(smoke) for c in seen)
    for c in seen:
        if c["section"] == "spec":
            assert c["ewma_alpha"] is None and c["host_threads"] == 1
        else:
            assert c["ewma_alpha"] == 0.0 and "host_threads" not in c
    seen.clear()
    bench_trend.collect(4, spec_ewma_alpha=0.5, spec_host_threads=8, device="cpu",
                        fastdecode=({"token_throughput": 1.0}, {0: [1]}), **extra)
    spec, = [c for c in seen if c["section"] == "spec"]
    assert spec["ewma_alpha"] == 0.5 and spec["host_threads"] == 8
    assert "fastdecode" not in {c["section"] for c in seen}


# the tracing A/B's runs in order, each as its steps' wall times: the
# untraced run handed in, the traced run, then (when that pair is over 5%)
# the re-measure's two runs, tracing the even and the odd steps; with the
# overhead the section must report and whether a re-measure run's tokens
# differ
OBS_AB = {
    "quiet host": ([[1, 1, 1, 1], [1, 1, 1, 1.02]], 1 - 24.9 / 25, False),
    "a slow host during the traced run, a free tracer": (
        [[1, 1, 1, 1], [1.5] * 4, [2, 2, 2, 2], [1.2, 1.2, 1.2, 1.2]], 0.0, False),
    "steps of unequal work, a free tracer": (
        [[1, 1, 1, 1], [1.5] * 4, [1, 3, 1, 3], [1, 3, 1, 3]], 0.0, False),
    "a tracer that costs 10%": (
        [[1, 1, 1, 1], [1.1] * 4, [2.2, 2, 2.2, 2], [1, 1.1, 1, 1.1]], 1 - 6 / 6.6, False),
    "runs of unequal length: the steps both have": (
        [[1, 1, 1, 1], [1.5] * 4, [1, 1, 1, 1], [1, 1, 1, 1, 9]], 0.0, False),
    "a re-measure run's tokens differ": (
        [[1, 1, 1, 1], [1.5] * 4, [1, 1, 1, 1], [1, 1, 1, 1]], 0.0, True),
}


@pytest.mark.parametrize("case", list(OBS_AB))
def test_obs_section_remeasures_on_alternate_steps(monkeypatch, capsys, baseline, case):
    """A host's speed moves from run to run by more than the tracing gate's
    5%.  Over 5%, the re-measure is two runs that trace alternate steps
    (``trace_parity`` 0 and 1): each step is timed once traced and once
    untraced, so a slow run cancels and so do uneven steps, while a tracer that
    costs 10% still fails ``gate``'s 5%; the re-measure runs' tokens are
    held to the bitwise gate."""
    from repro_torch.benchmarks import engine_real

    runs, want, diverge = OBS_AB[case]
    calls = []

    def result(steps):
        r = engine_real.RunResult(
            token_throughput=round(100 / sum(steps), 1), bubble_fraction=0.0,
            reconcile_ok=True, trace_events=1, trace_dropped=0)
        r.step_times = list(steps)
        return r

    def run(policy, n, tracing=False, trace_parity=None, **k):
        calls.append((tracing, trace_parity))
        bad = diverge and trace_parity == 1
        return result(runs[len(calls)]), {0: [2] if bad else [1]}

    monkeypatch.setattr(engine_real, "run", run)
    rc, res = engine_real.run_obs_section(3, off=(result(runs[0]), {0: [1]}))
    on = res["obs_tracing_on"]
    remeasured = len(runs) == 4
    assert calls == [(True, None)] + ([(False, 0), (False, 1)] if remeasured else [])
    assert on["tracing_overhead"] == pytest.approx(want, abs=1e-4)
    assert ("alternate steps" in capsys.readouterr().out) == remeasured
    assert rc == int(diverge)
    summary = copy.deepcopy(baseline)
    summary["obs"]["tracing_overhead"] = on["tracing_overhead"]
    assert bench_trend.gate(summary, baseline) == int(want > 0.05)
