"""The port's RWKV6 slice against the JAX package's: the plain chunked scan
and the decode step against the reference's oracles, the ssm model
(rwkv6-7b smoke config: 4 layers, d_model 128, 4 heads of 32, vocab 512,
fp32) on the same bridged weights, and the contiguous engine against the
reference engine.  Every test draws its inputs from its own seeded numpy
generator."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.kernels.rwkv6_scan import ops as ref_ops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_scan  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import get_model, param_count  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_reference_params,
    params_from_reference,
    params_to_reference,
)

ARCH = "rwkv6-7b"
TOL = dict(rtol=1e-4, atol=1e-4)  # model logits: same weights, fp32, other op order
ORACLE = dict(rtol=2e-3, atol=2e-3)  # tests/test_kernels.py: chunked vs step-by-step


def _scan_inputs(seed, B, T, H, N, strong=False):
    """The reference sweep's inputs (tests/test_kernels.py:100), or a decay
    of about exp(-5) per step (``strong``) that drives pair decays into the
    +-60 clip."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32) for _ in range(3))
    z = rng.normal(size=(B, T, H, N))
    if strong:
        z = np.log(5.0) + 0.1 * z
    w = np.exp(-np.exp(z)).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _pad_tail(arrs, chunk=16):
    """Pad T to a whole chunk the way the plain version does: w = 1 and
    r = k = v = 0 (which adds nothing and decays nothing)."""
    r, k, v, w, u, s0 = arrs
    pad = (-r.shape[1]) % chunk
    z = [(0, 0), (0, pad), (0, 0), (0, 0)]
    return (np.pad(r, z), np.pad(k, z), np.pad(v, z), np.pad(w, z, constant_values=1.0),
            u, s0)


def _close_to_scale(got, want, rel):
    """Same algorithm, other summation order: terms of the output's largest
    magnitude cancel to small entries, so the bound is ``rel`` of that
    magnitude (an elementwise 1e-5 fails on a handful of near-zero entries
    at 3e-5 when |y| reaches 60)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


SHAPES = [(1, 32, 2, 16, False), (2, 64, 4, 32, False),  # tests/test_kernels.py:100
          (1, 100, 2, 16, False),  # ragged T
          (2, 40, 3, 32, True)]  # strong decay, ragged


@pytest.mark.parametrize("B,T,H,N,strong", SHAPES)
def test_plain_scan_matches_chunked_oracle(B, T, H, N, strong):
    arrs = _scan_inputs(11, B, T, H, N, strong)
    y, sT = rwkv6_chunked(*map(torch.from_numpy, arrs))
    y_ref, s_ref = ref_scan.rwkv6_chunked_ref(*map(jnp.asarray, _pad_tail(arrs)))
    _close_to_scale(y.numpy(), np.asarray(y_ref)[:, :T], 1e-5)
    _close_to_scale(sT.numpy(), s_ref, 1e-5)


@pytest.mark.parametrize("B,T,H,N,strong", SHAPES)
def test_plain_scan_matches_step_oracle(B, T, H, N, strong):
    arrs = _scan_inputs(12, B, T, H, N, strong)
    y, sT = rwkv6_chunked(*map(torch.from_numpy, arrs))
    y_ref, s_ref = ref_scan.rwkv6_scan_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **ORACLE)
    np.testing.assert_allclose(sT.numpy(), np.asarray(s_ref), **ORACLE)


def test_decode_step_matches_reference():
    r, k, v, w, u, s0 = _scan_inputs(13, 3, 1, 2, 16)
    got = ops.rwkv6_decode_step(*map(torch.from_numpy, (r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                                        u, s0)))
    want = ref_ops.rwkv6_decode_step(*map(jnp.asarray, (r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                                         u, s0)))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    arrs = [torch.from_numpy(a) for a in _scan_inputs(14, 1, 20, 2, 16)]
    before = ops.rwkv6_scan.launches
    y, sT = ops.rwkv6_scan(*arrs)
    want = rwkv6_chunked(*arrs, chunk=ops.CHUNK)
    assert torch.equal(y, want[0]) and torch.equal(sT, want[1])
    assert ops.rwkv6_scan.launches == before  # the counter counts kernel launches only
    r, k, v, w, u, s0 = arrs
    bad = [((r.double(), k, v, w, u, s0), TypeError),
           ((r, k, v, w.bfloat16(), u, s0), TypeError),
           ((r, k[:, :10], v, w, u, s0), ValueError),
           ((r, k, v, w, u[:1], s0), ValueError),
           ((r.transpose(1, 2), k, v, w, u, s0), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            ops.rwkv6_scan(*args)


def test_group_norm_heads_matches_reference():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=(4, 32)).astype(np.float32) for _ in range(2))
    got = layers.group_norm_heads(*map(torch.from_numpy, (x, scale, bias)))
    want = ref_layers.group_norm_heads(*map(jnp.asarray, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    cfg_ref = ref_smoke(ARCH)
    ref = ref_get_model(cfg_ref)
    params = ref.init(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params)
    port = get_model(get_smoke_config(ARCH), device="cpu")
    load_reference_params(port, tree)
    return ref, params, tree, port


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_bridge_round_trip(pair):
    _, _, tree, port = pair
    back = dict(_leaves(params_to_reference(params_from_reference(tree, port.cfg), port.cfg)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    for k, a in want.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    loaded = dict(_leaves(params_to_reference(dict(port.named_parameters()), port.cfg)))
    for k, a in want.items():
        np.testing.assert_array_equal(loaded[k], a, err_msg=k)


def test_param_count_matches_reference(pair):
    ref, _, _, port = pair
    assert port.param_count() == ref.param_count() == param_count(port.cfg)
    assert param_count(get_config(ARCH)) == ref_get_model(ref_config(ARCH)).param_count()


def test_prefill_logits_and_state_match_reference(pair):
    ref, params, _, port = pair
    toks = np.random.default_rng(16).integers(1, 500, size=(2, 37)).astype(np.int32)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(toks))
    for impl in ("kernel", "plain"):
        p_logits, p_cache = port.prefill(torch.from_numpy(toks), impl=impl)
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
        for name in ("state", "tm_prev", "cm_prev"):
            assert tuple(p_cache[name].shape) == r_cache[name].shape
            np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]),
                                       **TOL, err_msg=name)
        np.testing.assert_array_equal(p_cache["lens"].numpy(), np.asarray(r_cache["lens"]))


def test_decode_logits_and_greedy_tokens_match_reference(pair):
    ref, params, _, port = pair
    prompt = np.random.default_rng(17).integers(1, 500, size=(1, 19)).astype(np.int32)
    decode = jax.jit(ref.decode)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(prompt))
    p_logits, p_cache = port.prefill(torch.from_numpy(prompt))
    for _ in range(12):
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
        tok = int(np.argmax(np.asarray(r_logits[0])))
        assert int(p_logits[0].argmax()) == tok
        r_logits, r_cache = decode(params, jnp.asarray([tok], jnp.int32), r_cache)
        p_logits, p_cache = port.decode(torch.tensor([tok]), p_cache)
    for name in ("state", "tm_prev", "cm_prev", "lens"):
        np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]), **TOL)


def test_decode_leaves_inactive_rows_alone(pair):
    _, _, _, port = pair
    toks = np.random.default_rng(18).integers(1, 500, size=(2, 9)).astype(np.int32)
    _, cache = port.prefill(torch.from_numpy(toks))
    before = {k: v.clone() for k, v in cache.items()}
    _, cache = port.decode(torch.tensor([3, 4]), cache, active=torch.tensor([True, False]))
    for name in ("state", "tm_prev", "cm_prev"):  # [L, B, ...]
        assert torch.equal(cache[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(cache[name][:, 0], before[name][:, 0]), name
    assert cache["lens"].tolist() == [10, 9]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(3))
    tree = jax.tree.map(np.asarray, params)
    return cfg_ref, params, params_from_reference(tree, get_smoke_config(ARCH))


def _run_both(weights, prompts, n_new, **ecfg):
    cfg_ref, params, state = weights
    kw = dict(pipeline=False, hw_profile="h100_sxm", ewma_alpha=0.0, **ecfg)
    ref = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
    port = NeoEngine(get_smoke_config(ARCH), EngineConfig(**kw), params=state, device="cpu")
    outs = []
    for eng in (ref, port):
        rids = [eng.submit(p, n_new) for p in prompts]
        out = eng.run_until_done(100)
        outs.append([out[r] for r in rids])
        eng.close()
    return ref, port, outs[0], outs[1]


def test_engine_matches_reference_engine(weights):
    """tests/test_engine.py:119's scenario (one prompt of 8, 5 tokens), then
    three requests submitted together, all prefilled in the first step."""
    rng = np.random.default_rng(19)
    for lens in ((8,), (8, 13, 5)):
        prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in lens]
        ref, port, ref_out, port_out = _run_both(weights, prompts, 5, max_batch_tokens=64,
                                                 policy="neo")
        assert port_out == ref_out
        assert all(len(o) == 5 for o in port_out)
        assert port.scheduler.policy == ref.scheduler.policy == "gpu_only"
        assert port.stats.mode_counts == ref.stats.mode_counts
        assert not port.paged and port.pool is None


def _oracle(port, prompt, n):
    logits, cache = port.prefill(torch.tensor([prompt]))
    seq = [int(logits[0].argmax())]
    for _ in range(n - 1):
        logits, cache = port.decode(torch.tensor([seq[-1]]), cache)
        seq.append(int(logits[0].argmax()))
    return seq


def test_staggered_prefill_keeps_each_request_exact(weights):
    """A 48-token budget prefills one 40-token prompt per step while the
    earlier requests decode.  The port advances only decoding slots, so each
    request emits its own oracle's tokens; the reference engine decodes every
    slot, so a request prefilled beside decoding rows takes a step on token 0
    first and leaves its oracle (ROADMAP queue 3)."""
    rng = np.random.default_rng(20)
    prompts = [list(map(int, rng.integers(1, 500, size=40))) for _ in range(3)]
    ref, port, ref_out, port_out = _run_both(weights, prompts, 5, max_batch_tokens=48,
                                             policy="neo")
    want = [_oracle(port.model, p, 5) for p in prompts]
    assert port_out == want
    assert ref_out[0] == want[0] and ref_out[1:] != want[1:]
