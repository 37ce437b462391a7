"""The benchmark's own arithmetic against the program's numbers: pool
sizes, the first waves, parameter counts, the kernels' work, the window's
percentiles, and the per-step records of the engine loop."""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import pytest  # noqa: E402

from bench import harness, traffic, yardstick as ys  # noqa: E402
from bench.window import Rec, Window, percentile, tpot_samples, ttft_samples  # noqa: E402
from repro_torch.testing import one_thread  # noqa: E402,F401

CONFIGS = ["qwen3-14b", "deepseek-moe-16b"]


def arch(cfg):
    from repro_torch.config import ArchConfig, MoEConfig

    port = dict(cfg["port"])
    moe = port.pop("moe", None)
    return ArchConfig(**port, moe=MoEConfig(**moe) if moe else None)


@pytest.mark.parametrize("name,pages", [("qwen3-14b", 9179), ("deepseek-moe-16b", 5680)])
def test_device_pool_pages(name, pages):
    assert harness.device_pages(harness.config_file(name)) == pages


@pytest.mark.parametrize("name,pages", [("qwen3-14b", 16198), ("deepseek-moe-16b", 10694)])
def test_port_rule_at_its_default_headroom(name, pages):
    """The port's ``size_pools`` default of 10% headroom, which left too
    little room for the prefill's activations on the card."""
    cfg = harness.config_file(name)
    from repro_torch.roofline.hw import get_profile
    from repro_torch.serving.simulator import size_pools

    assert ys.device_pages(cfg, dict(cfg["assumed"], activation_headroom=0.1)) == pages
    assert size_pools(arch(cfg), get_profile("h100_sxm"))[0] == pages


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_the_port(name):
    cfg = harness.config_file(name)
    a = arch(cfg)
    assert ys.param_count(cfg) == a.param_count()
    assert ys.kv_bytes_per_token(cfg) == a.kv_bytes_per_token(2)
    emb = ys.embedding_params(cfg)
    assert ys.linear_flops_per_token(cfg) == 2.0 * (a.active_param_count() - emb - cfg["hidden_size"])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_the_ports_config(name):
    """The file's port fields build the port's registered architecture, and
    its published keys say the same widths."""
    from repro_torch.configs import get_config

    cfg = harness.config_file(name)
    a = arch(cfg)
    assert a == get_config(name)
    assert (a.num_layers, a.d_model, a.num_heads, a.num_kv_heads, a.vocab_size) == (
        cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["vocab_size"])
    assert a.d_ff == cfg["intermediate_size"] and a.rope_theta == cfg["rope_theta"]
    if a.moe is not None:
        m = a.moe
        assert (m.num_experts, m.top_k, m.expert_d_ff, m.num_shared_experts,
                m.first_dense_layers) == (cfg["n_routed_experts"], cfg["num_experts_per_tok"],
                                          cfg["moe_intermediate_size"], cfg["n_shared_experts"],
                                          cfg["first_k_dense_replace"])
        assert m.capacity_factor == cfg["assumed"]["capacity_factor"]


CELLS = [(w["config"], w["traffic"]) for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.parametrize("config,mix", CELLS)
def test_client_counts(config, mix):
    """The first wave (the requests in flight at the steady state's start)
    fits the device KV pool: the cells' traffic fits, and no row starts on
    the host."""
    cfg, mix = harness.config_file(config), harness.mix_file(mix)
    tokens = harness.device_pages(cfg) * cfg["assumed"]["page_tokens"]
    tr = traffic.Traffic(mix, cfg, 1)
    wave = tr.first_wave()
    assert len(wave) == mix["first_wave"]
    held = sum(len(a.prompt) + a.max_new_tokens for a in wave)
    assert held < tokens


def test_host_pool_of_the_offload_mix():
    """A mix's host pool share sizes the host pool against the device's."""
    from bench import testing, weights

    cfg, ref = testing.dense(), harness.reference("dense")
    eng = harness.build_engine(cfg, testing.chat(host_pool_share=0.5),
                               weights.Drawn(ref.weight_groups(cfg), 1, "cpu"), "cpu")
    try:
        e = eng.engine_cfg
        assert e.host_pool_pages == round(0.5 * harness.device_pages(cfg))
    finally:
        eng.close()


@pytest.mark.parametrize("config,mix", CELLS)
def test_work_is_the_same_for_every_seed(config, mix):
    mix, hf = harness.mix_file(mix), harness.config_file(config)
    a, b = traffic.Traffic(mix, hf, 1), traffic.Traffic(mix, hf, 2**31 + 5)
    assert [(len(x.prompt), x.max_new_tokens) for x in a.first_wave()] == [
        (len(x.prompt), x.max_new_tokens) for x in b.first_wave()]
    ta, tb = a.arrivals(), b.arrivals()
    arr_a, arr_b = [next(ta) for _ in range(50)], [next(tb) for _ in range(50)]
    assert [(x.due, len(x.prompt)) for x in arr_a] == [(x.due, len(x.prompt)) for x in arr_b]
    assert a._ask(0).prompt != b._ask(0).prompt
    again = traffic.Traffic(mix, hf, 1)
    assert again.first_wave()[3].prompt == a.first_wave()[3].prompt
    assert arr_a[0].prompt != a.first_wave()[0].prompt
    gaps = [y.due - x.due for x, y in zip(arr_a, arr_a[1:])]
    assert sum(gaps) / len(gaps) == pytest.approx(1 / mix["rate"], rel=0.5)


@pytest.mark.parametrize("config,mix", CELLS)
def test_context_cut(config, mix):
    hf = harness.config_file(config)
    sizes = traffic.size_set(harness.mix_file(mix), hf["max_position_embeddings"])
    assert (sizes.sum(axis=1) <= hf["max_position_embeddings"]).all()
    assert (sizes[:, 1] >= 1).all()


def test_kernel_work():
    hf = harness.config_file("qwen3-14b")  # H 40, KV 8, hd 128
    f, b = ys.paged_decode_call(hf, [100, 28])
    assert f == 4 * 40 * 128 * 128 and b == 2 * (2 * 8 * 128 * 128 + 2 * 40 * 128 * 2)
    f, b = ys.flash_prefill_call(hf, [3])
    assert f == 4 * 40 * 128 * 6 and b == 2 * (80 + 16) * 128 * 3
    assert ys.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert ys.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_window_arithmetic():
    win = Window(t0=10.0, t1=20.0)
    recs = {
        0: Rec(0, [1], 4, due=9.0, submitted=9.0, first=11.0),  # due before: not sampled
        1: Rec(1, [1], 4, due=12.0, submitted=12.0, first=13.5),
        2: Rec(2, [1], 4, due=19.0, submitted=19.0),  # still waiting: 1 s so far
        3: Rec(3, [1], 4, due=15.0, submitted=15.0, first=21.0),  # after close: counts to t1
    }
    assert sorted(ttft_samples(recs, win)) == [1.0, 1.5, 5.0]
    recs[1].win_n, recs[1].win_first, recs[1].win_last = 5, 13.5, 15.5
    recs[0].win_n, recs[0].win_first, recs[0].win_last = 1, 11.0, 11.0
    assert tpot_samples(recs) == [0.5]
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)
    assert percentile([], 90) is None


class _Req:
    def __init__(self, prompt):
        from repro_torch.core.request import RequestState

        self.prompt, self.out_tokens, self.location = prompt, [], "gpu"
        self.state, self.max_new = RequestState.RUNNING, 3


class _Stats:
    prefill_tokens = 0


class _Engine:
    """Two requests: one decodes on the device, one on the host."""

    def __init__(self):
        self.requests = {0: _Req([1] * 10), 1: _Req([1] * 30)}
        self.stats = _Stats()
        self.steps = 0

    def submit(self, prompt, max_new):
        return len(self.requests) - 1

    def step(self):
        from repro_torch.core.request import RequestState

        self.steps += 1
        if self.steps == 1:
            self.stats.prefill_tokens += 40
        else:
            self.requests[1].location = "cpu"
        out = []
        for rid, r in self.requests.items():
            r.out_tokens.append(7)
            if len(r.out_tokens) >= r.max_new:
                r.state = RequestState.FINISHED
            out.append((rid, 7))
        return out


def test_engine_loop_records_each_step():
    eng = _Engine()
    drv = harness.EngineLoop(eng, clock=iter(range(100)).__next__)
    recs = [Rec(rid, r.prompt, 3, 0.0, 0.0) for rid, r in eng.requests.items()]
    drv.recs = drv.active = {r.rid: r for r in recs}
    drv.recs = dict(drv.active)
    drv.win = Window(t0=0.0)
    drv.step()
    done = drv.step() + drv.step()
    s0, s1 = drv.win.steps[:2]
    assert s0.prefill_lens == [10, 30] and recs[0].batch_len == recs[1].batch_len == 30
    assert s1.dev_ctx == [11] and s1.host_ctx == [31]  # prompt + the token fed
    assert recs[1].host_tokens == 2 and recs[0].host_tokens == 0
    assert sorted(r.rid for r in done) == [0, 1] and drv.win.tokens == 6
    assert math.isclose(recs[0].win_last - recs[0].win_first, 4)
