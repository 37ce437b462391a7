"""The port's serial NeoEngine against the JAX reference engine: the
scenarios of ``tests/test_engine.py`` run on both engines with
``pipeline=False``, the same bridged weights and the perf model frozen
(``ewma_alpha=0``), and every request's greedy tokens must be identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.request import RequestState  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def weights():
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params)
    return cfg_ref, params, params_from_reference(tree, get_smoke_config(ARCH))


def _engines(weights, **ecfg):
    cfg_ref, params, state = weights
    kw = dict(pipeline=False, hw_profile="h100_sxm", ewma_alpha=0.0, **ecfg)
    ref = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
    port = NeoEngine(get_smoke_config(ARCH), EngineConfig(**kw), params=state,
                     device="cpu")
    return ref, port


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=n))) for n in lens]


def _run_both(weights, prompts, n_new, max_iters=500, eos=None, **ecfg):
    ref, port = _engines(weights, **ecfg)
    outs = []
    for eng in (ref, port):
        rids = [eng.submit(p, n_new, eos_token=eos) for p in prompts]
        out = eng.run_until_done(max_iters)
        outs.append([out[r] for r in rids])
        eng.close()
    return ref, port, outs[0], outs[1]


@pytest.mark.parametrize("policy", ["neo", "gpu_only", "fastdecode", "simple"])
def test_policies_match_reference(policy, weights):
    _, _, ref_out, port_out = _run_both(
        weights, _prompts(1, (7, 19, 26)), 8, device_pool_pages=7,
        host_pool_pages=96, max_batch_tokens=64, policy=policy)
    assert port_out == ref_out
    assert all(len(o) == 8 for o in port_out)


def test_tight_pools_offload_and_swap(weights):
    ref, port, ref_out, port_out = _run_both(
        weights, _prompts(2, (24, 30, 18, 22)), 6, device_pool_pages=7,
        host_pool_pages=128, max_batch_tokens=128, policy="neo")
    assert port_out == ref_out
    assert all(r.state == RequestState.FINISHED for r in port.requests.values())
    assert port.stats.offloaded_decodes > 0 and port.pool.swap_bytes > 0
    # same frozen perf model -> same plans -> same page traffic
    assert port.stats.offloaded_decodes == ref.stats.offloaded_decodes
    assert port.stats.device_decodes == ref.stats.device_decodes
    assert port.pool.swap_bytes == ref.pool.swap_bytes


def test_recompute_preemption(weights):
    ref, port, ref_out, port_out = _run_both(
        weights, _prompts(3, (20, 24, 22)), 10, device_pool_pages=5,
        host_pool_pages=4, max_batch_tokens=64, policy="neo")
    assert port_out == ref_out
    assert port.stats.mode_counts == ref.stats.mode_counts


def test_journal_replay(weights):
    p = _prompts(4, (11,))[0]
    ref, port = _engines(weights, device_pool_pages=16, host_pool_pages=32)
    full = ref.submit(p, 12)
    want = ref.run_until_done(200)[full]
    rid = port.submit(p, 12)
    for _ in range(5):
        port.step(now=port.clock + 1e-3)
    pre = list(port.requests[rid].out_tokens)
    assert 0 < len(pre) < 12
    journal = port.export_journal()
    _, port2 = _engines(weights, device_pool_pages=16, host_pool_pages=32)
    mapping = port2.replay_journal(journal)
    assert pre + port2.run_until_done(200)[mapping[rid]] == want


def test_admission_control(weights):
    ref, port = _engines(weights, device_pool_pages=4, host_pool_pages=4,
                         max_batch_tokens=64, policy="neo")
    for eng, state in ((ref, RefState), (port, RequestState)):
        big = eng.submit(list(range(1, 200)), 8)  # can never fit any pool
        ok = eng.submit([1, 2, 3, 4], 4)
        eng.run_until_done(100)
        assert eng.requests[big].state == state.ABORTED
        assert eng.requests[ok].state == state.FINISHED
    assert port.requests[1].out_tokens == ref.requests[1].out_tokens


def test_offer_respects_max_waiting(weights):
    _, port = _engines(weights, max_waiting=1)
    assert port.offer([1, 2, 3], 2) is not None
    assert port.offer([4, 5, 6], 2) is None
    assert port.stats.rejected_requests == 1


def test_eos_stop(weights):
    p = _prompts(5, (9,))
    _, _, ref_out, _ = _run_both(weights, p, 6, device_pool_pages=16,
                                 host_pool_pages=16)
    eos = ref_out[0][2]
    _, _, ref_eos, port_eos = _run_both(weights, p, 6, eos=eos,
                                        device_pool_pages=16, host_pool_pages=16)
    assert port_eos == ref_eos
    assert port_eos[0][-1] == eos and len(port_eos[0]) <= 3
