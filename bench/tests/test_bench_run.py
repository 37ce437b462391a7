"""The whole run at smoke size on the CPU, the card's look skipped: set-up,
window, reference and metrics, and ``correct`` false under each fault the
cells can have, planted in the program beneath the timed path."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from bench import harness, testing  # noqa: E402
from repro_torch.testing import one_thread  # noqa: E402,F401

SEED = 3_000_000_017
SECONDS = 0.6


def run(cfg, mix, trace_metrics=False, seed=SEED):
    spec = harness.benchmark_spec()
    metrics = harness.metrics_for(spec, spec["workloads"][0]["name"], trace_metrics)
    return harness.execute(testing.CELL, cfg, mix, metrics, seed, SECONDS, False,
                           torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("make", [testing.dense, testing.moe], ids=["dense", "moe"])
def test_smoke_run_is_correct(make):
    res = run(make(), testing.chat())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    m = res["metrics"]
    assert set(m) == {x["name"] for x in harness.benchmark_spec()["end_to_end"]}
    assert all(v["value"] > 0 for v in m.values())
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("make", [testing.dense, testing.moe], ids=["dense", "moe"])
def test_control_fails_the_limit(make):
    """The float8 control in the program's place, on three seeds: above the
    configuration's limit on each (the smoke limits were set between the
    program's readings and the control's)."""
    cfg = make()
    for seed in (SEED, SEED + 1, SEED + 2):
        r, _ = harness.run_cell(testing.CELL, cfg, testing.chat(), seed, SECONDS, False,
                                torch.device("cpu"), time.perf_counter())
        c = harness.check(r, seed, "cpu", control=True)
        for name, limit in cfg["limits"].items():
            assert c[name] <= limit < c["control"][name], (name, c)


def test_smoke_counters():
    res = run(testing.dense(), testing.chat(), trace_metrics=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["step_ms"] > 0 and m["decode_rows_mean"] > 0 and m["step_mfu"] > 0
    assert 0 <= m["host_row_share"] <= 100 and 0 <= m["prefill_busy_share"] <= 100
    assert m["ttft_p90_s"] > 0
    assert "device_idle_share" not in m  # no trace: nothing to read


def test_knobs_of_config_then_mix():
    from bench import weights

    cfg = testing.dense()
    cfg["assumed"]["engine"].update(host_threads=2, planahead=False)
    mix = testing.chat(engine={"planahead": True})
    ref = harness.reference("dense")
    eng = harness.build_engine(cfg, mix, weights.Drawn(ref.weight_groups(cfg), 1, "cpu"), "cpu")
    try:
        e = eng.engine_cfg
        assert (e.host_threads, e.planahead, e.max_requests, e.policy) == (2, True, 512, "neo")
        assert e.host_pool_pages == round(0.6 * e.device_pool_pages)
        snap = harness.stats_snapshot(eng)
        assert {"device_decodes", "lane_busy_time", "transfer.bytes_out"} <= set(snap)
    finally:
        eng.close()


def test_open_loop_smoke():
    """Arrivals after the first wave: due in the window, each with a prompt
    of its own (not the first wave's again)."""
    cfg, mix = testing.dense(), testing.chat(host_pool_share=None)
    r, extra = harness.run_cell(testing.CELL, cfg, mix, SEED, SECONDS, False,
                                torch.device("cpu"), time.perf_counter())
    assert extra["first_wave"] == mix["first_wave"] and extra["attempted"] > 0
    assert len(r.win.lateness) >= extra["attempted"] and max(r.win.lateness) >= 0
    prompts = [tuple(x.prompt) for x in r.recs.values()]
    assert len(set(prompts)) == len(prompts)


def _keep_kv_unchanged(monkeypatch):
    """A step that leaves its state unchanged: prefill K/V never reach the pools."""
    from repro_torch.core.kv_cache import PagePool

    monkeypatch.setattr(PagePool, "put_pages", lambda self, *a, **k: None)


def _half_the_batch(monkeypatch):
    """Half of the batch left out: each decode pass computes its first half
    of rows and hands those logits to the rest."""
    from repro_torch.core.executor import PagedExecutor

    inner = PagedExecutor.decode

    def decode(self, rows, host_flags):
        h = max(1, (len(rows) + 1) // 2)
        out = inner(self, rows[:h], host_flags[:h])
        return np.concatenate([out, out[: len(rows) - h]])

    monkeypatch.setattr(PagedExecutor, "decode", decode)
    monkeypatch.setattr(PagedExecutor, "decode_batch0", decode)


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every 16th sampled token."""
    from repro_torch.core.engine import NeoEngine

    inner = NeoEngine._sample
    count = [0]

    def sample(self, logits):
        count[0] += 1
        tok = inner(self, logits)
        return (tok + 1) % len(logits) if count[0] % 16 == 0 else tok

    monkeypatch.setattr(NeoEngine, "_sample", sample)


@pytest.mark.parametrize("fault", [_keep_kv_unchanged, _half_the_batch, _alter_tokens],
                         ids=["state-unchanged", "half-batch", "token-altered"])
@pytest.mark.parametrize("make", [testing.dense, testing.moe], ids=["dense", "moe"])
def test_fault_fails_the_check(monkeypatch, fault, make):
    fault(monkeypatch)
    res = run(make(), testing.chat())
    assert not res["correct"], res["checks"]
