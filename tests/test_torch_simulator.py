"""The port's serving simulator (``repro_torch.serving.simulator``) against
the JAX package's, case by case over ``tests/test_simulator.py``.

The simulator is plain Python over the port's copies of the config, perf
model, request, scheduler, hardware profiles, metrics and traces, so on the
same trace, hardware profile and policy the port must return the
reference's metrics EXACTLY: every request record (arrival, first token,
finish), the makespan, the iteration and mode counts, and the pool sizes of
``size_pools``.  The reference test's qualitative claims (every request
completes, NEO never loses to GPU-only at saturation, the T4 gain,
FastDecode+ degrading at long outputs, host bandwidth monotonicity,
strawman #1 no faster than FastDecode+) are then asserted on the port's
numbers.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs.paper_models  # noqa: E402,F401  (registers the paper's models)
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.perfmodel import PerfModel as RefPerfModel  # noqa: E402
from repro.roofline.hw import get_profile as ref_get_profile  # noqa: E402
from repro.serving import simulator as ref_sim  # noqa: E402
from repro.serving import traces as ref_traces  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
import repro_torch.configs.paper_models  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.perfmodel import PerfModel  # noqa: E402
from repro_torch.roofline.hw import get_profile  # noqa: E402
from repro_torch.serving import simulate, size_pools  # noqa: E402
from repro_torch.serving import traces  # noqa: E402

SIDES = {"ref": (ref_get_config, ref_get_profile, ref_sim.simulate, ref_sim.size_pools,
                 ref_traces),
         "port": (get_config, get_profile, simulate, size_pools, traces)}

# the reference test's runs, one entry per simulation test of
# tests/test_simulator.py: (model, [(trace generator, arguments, hw,
# policy, tp)])
def _syn(n, rate, li, lo, seed):
    return ("synthetic_trace", (n, rate, li, lo), dict(seed=seed))


CASES = {
    "all_requests_complete": ("llama2-7b", [
        ("osc_trace", (60,), dict(rate=2.0, seed=0), "t4_g4dn", "neo", 1)]),
    "neo_never_loses_to_baseline_at_saturation": ("llama2-7b", [
        (*_syn(150, 30.0, 400, 50, 1), "t4_g4dn", p, 1) for p in ("gpu_only", "neo")]),
    "t4_headline_gain": ("llama2-7b", [
        (*_syn(200, 50.0, 400, 50, 0), "t4_g4dn", p, 1) for p in ("gpu_only", "neo")]),
    "fastdecode_degrades_at_long_outputs": ("llama31-70b", [
        (*_syn(80, 10.0, 2000, 400, 0), "h100_sxm", p, 2) for p in ("neo", "fastdecode")]),
    "host_bandwidth_monotonicity": ("llama31-8b", [
        (*_syn(150, 50.0, 1000, lo, 0), hw, p, 1) for hw in ("a10g_g5_2x", "a10g_g5_16x")
        for lo in (100, 400) for p in ("gpu_only", "neo")]),
    "simple_offload_slower_than_pipelined": ("llama2-7b", [
        (*_syn(80, 20.0, 400, 50, 0), "t4_g4dn", p, 1) for p in ("fastdecode", "simple")]),
}


def _trace_rows(trace):
    return [(t.arrival_time, t.prompt_len, t.output_len) for t in trace]


def _run(side, model, runs):
    """{(hw, output length, policy): (metrics, trace rows)} on one side."""
    get_cfg, _, sim, _, trace_mod = SIDES[side]
    cfg = get_cfg(model)
    out = {}
    for name, args, kw, hw, policy, tp in runs:
        trace = getattr(trace_mod, name)(*args, **kw)
        lo = args[3] if name == "synthetic_trace" else None
        out[hw, lo, policy] = (sim(cfg, trace, hw=hw, policy=policy, tp=tp),
                               _trace_rows(trace))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_matches_reference(case):
    model, runs = CASES[case]
    ref, port = _run("ref", model, runs), _run("port", model, runs)
    assert ref.keys() == port.keys()
    for key in ref:
        (m_ref, tr_ref), (m_port, tr_port) = ref[key], port[key]
        assert tr_port == tr_ref, key
        assert dataclasses.asdict(m_port) == dataclasses.asdict(m_ref), key
        assert (m_port.makespan, m_port.throughput) == (m_ref.makespan, m_ref.throughput)
        assert m_port.summary() == m_ref.summary(), key
    thr = {(hw, lo, p): m.throughput for (hw, lo, p), (m, _) in port.items()}
    if case == "all_requests_complete":
        m = port["t4_g4dn", None, "neo"][0]
        assert len(m.finished) >= 50
        for r in m.finished:
            assert r.finish_time >= r.arrival_time and r.first_token_time is not None
    elif case == "neo_never_loses_to_baseline_at_saturation":
        assert thr["t4_g4dn", 50, "neo"] >= 0.95 * thr["t4_g4dn", 50, "gpu_only"]
    elif case == "t4_headline_gain":
        assert thr["t4_g4dn", 50, "neo"] >= 1.3 * thr["t4_g4dn", 50, "gpu_only"]
    elif case == "fastdecode_degrades_at_long_outputs":
        assert thr["h100_sxm", 400, "neo"] > thr["h100_sxm", 400, "fastdecode"]
    elif case == "host_bandwidth_monotonicity":
        # Fig. 10a: the best NEO / GPU-only ratio over the two output
        # lengths grows with host memory bandwidth (g5.16x over g5.2x)
        best = {hw: max(thr[hw, lo, "neo"] / thr[hw, lo, "gpu_only"] for lo in (100, 400))
                for hw in ("a10g_g5_2x", "a10g_g5_16x")}
        assert best["a10g_g5_16x"] > best["a10g_g5_2x"], best
    elif case == "simple_offload_slower_than_pipelined":
        assert thr["t4_g4dn", 50, "fastdecode"] >= thr["t4_g4dn", 50, "simple"]


@pytest.mark.parametrize("model,hw", [("llama2-7b", "t4_g4dn"), ("llama31-8b", "h100_sxm"),
                                      ("llama31-70b", "h100_sxm"), ("qwen3-14b", "a10g_g5_4x")])
def test_size_pools_matches_reference(model, hw):
    got = size_pools(get_config(model), get_profile(hw))
    assert got == ref_sim.size_pools(ref_get_config(model), ref_get_profile(hw))
    assert size_pools(get_config(model), get_profile(hw), tp=2) == \
        ref_sim.size_pools(ref_get_config(model), ref_get_profile(hw), tp=2)
    if (model, hw) == ("llama2-7b", "t4_g4dn"):
        assert got[0] * 16 < 4000  # the T4 + 7B pool holds a few thousand tokens
    if (model, hw) == ("llama31-8b", "h100_sxm"):
        assert got[0] * 16 > 200_000  # the H100 + 8B pool holds hundreds of thousands


def test_ewma_calibration_clamped_matches_reference():
    pms = [cls.for_arch(get("llama2-7b"), "t4_g4dn", ewma_alpha=0.5)
           for cls, get in ((PerfModel, get_config), (RefPerfModel, ref_get_config))]
    for pm in pms:
        for _ in range(50):
            pm.observe("cpu_attn", 1e-6, 1.0)  # measured 1e6 x predicted
    assert pms[0].scale == pms[1].scale and pms[0].scale["cpu_attn"] <= PerfModel.SCALE_MAX
    for pm in pms:
        for _ in range(50):
            pm.observe("cpu_attn", 1.0, 1e-6)
    assert pms[0].scale == pms[1].scale and pms[0].scale["cpu_attn"] >= PerfModel.SCALE_MIN
