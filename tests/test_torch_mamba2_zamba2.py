"""The port's Mamba2 / Zamba2 slice against the JAX package's: the plain
chunked SSD scan and the decode step against the reference's oracles (P != N
included: the reference sweep never pins the [B, H, N, P] state layout),
the Mamba2 block, the hybrid model (zamba2-7b smoke config: 7 Mamba2 blocks
in 2 groups of 3 plus a tail of 1, 3 shared-attention applications,
d_model 128, P = 32, N = 16, fp32) on the same bridged weights, including a
decode that wraps the shared attention's ring buffer, and the contiguous
engine against the reference engine.  Every test draws its inputs from its
own seeded numpy generator."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.kernels.mamba2_ssd import ops as ref_ops  # noqa: E402
from repro.kernels.mamba2_ssd import ref as ref_ssd  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.models.mamba2 import Mamba2Block as RefMamba2Block  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked  # noqa: E402
from repro_torch.models.api import get_model, param_count  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_reference_params,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.mamba2 import Mamba2Block  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)  # model logits: same weights, fp32, other op order
ORACLE = dict(rtol=2e-3, atol=2e-3)  # tests/test_kernels.py: chunked vs step-by-step


def _ssd_inputs(seed, B, T, H, P, N, strong=False):
    """The reference sweep's inputs (tests/test_kernels.py:137, with the
    state as [B, H, N, P]), or a log decay of about -4 per step
    (``strong``) that drives the pair decays into the +-60 clip."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    lo, hi, alo, ahi = (1.0, 3.0, 1.0, 3.0) if strong else (0.001, 0.1, 0.5, 2.0)
    dt = rng.uniform(lo, hi, size=(B, T, H)).astype(np.float32)
    A = -rng.uniform(alo, ahi, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    C = rng.normal(size=(B, T, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, P)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, C, D, s0


def _pad_tail(arrs, chunk):
    """Pad T to a whole chunk the way the plain version does: dt = 0 and
    x = B = C = 0 (which adds nothing and decays nothing)."""
    x, dt, A, Bm, C, D, s0 = arrs
    pad = (-x.shape[1]) % chunk
    t = lambda a: np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))  # noqa: E731
    return t(x), t(dt), A, t(Bm), t(C), D, s0


def _close_to_scale(got, want, rel):
    """Same algorithm, other summation order: terms of the output's largest
    magnitude cancel to small entries, so the bound is ``rel`` of that
    magnitude (an elementwise 1e-5 fails on the strong-decay case, where
    |y| reaches the hundreds)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


SHAPES = [(1, 32, 2, 16, 16, False), (2, 64, 2, 32, 32, False),  # tests/test_kernels.py:137
          (1, 100, 3, 32, 16, False),  # ragged T, P != N (the smoke shape)
          (2, 130, 4, 24, 40, True)]  # strong decay, P != N, ragged


@pytest.mark.parametrize("B,T,H,P,N,strong", SHAPES)
def test_plain_scan_matches_chunked_oracle(B, T, H, P, N, strong):
    arrs = _ssd_inputs(21, B, T, H, P, N, strong)
    y, sT = mamba2_ssd_chunked(*map(torch.from_numpy, arrs))
    y_ref, s_ref = ref_ssd.mamba2_ssd_chunked_ref(*map(jnp.asarray, _pad_tail(arrs, 64)))
    _close_to_scale(y.numpy(), np.asarray(y_ref)[:, :T], 1e-5)
    _close_to_scale(sT.numpy(), s_ref, 1e-5)


@pytest.mark.parametrize("B,T,H,P,N,strong", SHAPES)
def test_plain_scan_matches_step_oracle(B, T, H, P, N, strong):
    arrs = _ssd_inputs(22, B, T, H, P, N, strong)
    y, sT = mamba2_ssd_chunked(*map(torch.from_numpy, arrs))
    y_ref, s_ref = ref_ssd.mamba2_ssd_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **ORACLE)
    np.testing.assert_allclose(sT.numpy(), np.asarray(s_ref), **ORACLE)


def test_decode_step_matches_reference():
    x, dt, A, Bm, C, D, s0 = _ssd_inputs(23, 3, 1, 2, 32, 16)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], D, s0)
    got = ops.mamba2_decode_step(*map(torch.from_numpy, args))
    want = ref_ops.mamba2_decode_step(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    arrs = [torch.from_numpy(a) for a in _ssd_inputs(24, 1, 20, 2, 32, 16)]
    before = ops.mamba2_ssd.launches
    y, sT = ops.mamba2_ssd(*arrs)
    want = mamba2_ssd_chunked(*arrs, chunk=ops.CHUNK)
    assert torch.equal(y, want[0]) and torch.equal(sT, want[1])
    assert ops.mamba2_ssd.launches == before  # the counter counts kernel launches only
    x, dt, A, Bm, C, D, s0 = arrs
    bad = [((x.double(), dt, A, Bm, C, D, s0), TypeError),
           ((x, dt, A, Bm.bfloat16(), C, D, s0), TypeError),
           ((x, dt.bfloat16(), A, Bm, C, D, s0), TypeError),
           ((x, dt, A, Bm, C, D, s0.transpose(2, 3).contiguous()), ValueError),  # [B,H,P,N]
           ((x, dt[:, :5], A, Bm, C, D, s0), ValueError),
           ((x.transpose(1, 2), dt, A, Bm, C, D, s0), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            ops.mamba2_ssd(*args)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def test_mamba2_block_seq_and_step_match_reference():
    cfg_ref = ref_smoke(ARCH)
    ref = RefMamba2Block(cfg_ref)
    p = ref.init(jax.random.key(5))
    port = Mamba2Block(get_smoke_config(ARCH), torch.float32, "cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(port, name).copy_(torch.from_numpy(np.array(leaf)))
    rng = np.random.default_rng(25)
    x = rng.normal(size=(2, 11, cfg_ref.d_model)).astype(np.float32)
    ssm = (rng.normal(size=(2, port.H, port.N, port.P)) * 0.1).astype(np.float32)
    conv = rng.normal(size=(2, port.conv_dim, port.K - 1)).astype(np.float32)
    want, want_s = ref.apply_seq(p, jnp.asarray(x), {"ssm": jnp.asarray(ssm),
                                                      "conv": jnp.asarray(conv)})
    for impl in ("kernel", "plain"):
        got, got_s = port.apply_seq(torch.from_numpy(x), {"ssm": torch.from_numpy(ssm),
                                                          "conv": torch.from_numpy(conv)},
                                    impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(got_s[name].numpy(), np.asarray(want_s[name]), **TOL)
    want, want_s = ref.apply_step(p, jnp.asarray(x[:, 0]), want_s)
    got, got_s = port.apply_step(torch.from_numpy(x[:, 0]), got_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(got_s[name].numpy(), np.asarray(want_s[name]), **TOL)


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
    assert port.n_groups == 2 and port.tail == 1  # both stacks exercised
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


def test_prefill_logits_and_cache_match_reference(pair):
    ref, params, _, port = pair
    toks = np.random.default_rng(26).integers(1, 500, size=(2, 21)).astype(np.int32)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(toks), capacity=24)
    for impl in ("kernel", "plain"):
        p_logits, p_cache = port.prefill(torch.from_numpy(toks), capacity=24, impl=impl)
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
        for name in ("ssm", "conv", "k", "v"):
            assert tuple(p_cache[name].shape) == r_cache[name].shape
            np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]),
                                       **TOL, err_msg=name)
        np.testing.assert_array_equal(p_cache["lens"].numpy(), np.asarray(r_cache["lens"]))


def test_decode_past_capacity_matches_reference(pair):
    """Prompt 21, capacity 24, 12 decode steps: the shared attention's ring
    buffer wraps after the third."""
    ref, params, _, port = pair
    prompt = np.random.default_rng(27).integers(1, 500, size=(1, 21)).astype(np.int32)
    decode = jax.jit(ref.decode)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(prompt), capacity=24)
    p_logits, p_cache = port.prefill(torch.from_numpy(prompt), capacity=24)
    for _ in range(12):
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
        tok = int(np.argmax(np.asarray(r_logits[0])))
        assert int(p_logits[0].argmax()) == tok
        r_logits, r_cache = decode(params, jnp.asarray([tok], jnp.int32), r_cache)
        p_logits, p_cache = port.decode(torch.tensor([tok]), p_cache)
    assert int(p_cache["lens"][0]) == 33 > 24
    for name in ("ssm", "conv", "k", "v", "lens"):
        np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]), **TOL,
                                   err_msg=name)


def test_decode_leaves_inactive_rows_alone(pair):
    _, _, _, port = pair
    toks = np.random.default_rng(28).integers(1, 500, size=(2, 9)).astype(np.int32)
    _, cache = port.prefill(torch.from_numpy(toks), capacity=16)
    before = {k: v.clone() for k, v in cache.items()}
    _, cache = port.decode(torch.tensor([3, 4]), cache, active=torch.tensor([True, False]))
    for name in ("ssm", "conv", "k", "v"):  # [layers or applications, B, ...]
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
    three requests submitted together, all prefilled in the first step.
    zamba2-7b keeps ``supports_offload=True`` but is of the hybrid family, so
    both engines take the contiguous path under the neo policy."""
    rng = np.random.default_rng(29)
    for lens in ((8,), (8, 13, 5)):
        prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in lens]
        ref, port, ref_out, port_out = _run_both(weights, prompts, 5, max_batch_tokens=64,
                                                 policy="neo")
        assert port_out == ref_out
        assert all(len(o) == 5 for o in port_out)
        assert not ref.paged and not port.paged and port.pool is None
        assert port.scheduler.policy == ref.scheduler.policy == "neo"
        assert port.stats.mode_counts == ref.stats.mode_counts


def test_staggered_prefill_keeps_each_request_exact(weights):
    """As in tests/test_torch_rwkv6.py: one 40-token prefill per step beside
    decoding rows; the port's tokens are each request's own oracle's, the
    reference engine's leave it after the first request (ROADMAP queue 3)."""
    rng = np.random.default_rng(30)
    prompts = [list(map(int, rng.integers(1, 500, size=40))) for _ in range(3)]
    ref, port, ref_out, port_out = _run_both(weights, prompts, 5, max_batch_tokens=48,
                                             policy="neo")
    want = []
    for p in prompts:
        logits, cache = port.model.prefill(torch.tensor([p]), capacity=48)
        seq = [int(logits[0].argmax())]
        for _ in range(4):
            logits, cache = port.model.decode(torch.tensor([seq[-1]]), cache)
            seq.append(int(logits[0].argmax()))
        want.append(seq)
    assert port_out == want
    assert ref_out[0] == want[0] and ref_out[1:] != want[1:]
