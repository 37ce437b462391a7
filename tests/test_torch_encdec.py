"""The port's encoder-decoder (audio family, seamless-m4t-medium) against
the JAX package's, at the smoke size (2 encoder and 4 decoder layers,
d_model 128, fp32), weights carried over through ``models/bridge.py``: the
model's prefill and decode, and the contiguous engine with the requests'
``frames`` extras (the ``seamless-m4t-medium`` case of the reference's
``test_contiguous_families_engine``, then several requests against the
reference's engine; every prefill lands in the first step, so the
reference's spurious token-0 decode step, which the port does not carry,
never runs: ROADMAP queue 3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_reference_params,
    params_from_reference,
    params_to_reference,
)

ARCH = "seamless-m4t-medium"
CFG = get_smoke_config(ARCH)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    ref = ref_get_model(ref_smoke(ARCH))
    params = ref.init(jax.random.key(3))
    tree = jax.tree.map(np.asarray, params)
    port = load_reference_params(get_model(CFG, device="cpu"), tree)
    return ref, params, tree, port


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_bridge_round_trip(pair):
    ref, _, tree, port = pair
    want = dict(_leaves(tree))
    for state in (params_from_reference(tree, CFG), dict(port.named_parameters())):
        back = dict(_leaves(params_to_reference(state, CFG)))
        assert back.keys() == want.keys()
        for k, a in want.items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)
    assert port.param_count() == ref.param_count()


def test_prefill_and_decode_match_reference(pair):
    """Encoder over the frames (non-causal), causal decoder with cross
    attention, the caches, then decode steps over both caches."""
    ref, params, _, port = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 500, size=(2, 11)).astype(np.int32)
    frames = rng.normal(size=(2, 9, CFG.d_model)).astype(np.float32)
    r_lo, r_c = ref.prefill(params, jnp.asarray(toks), capacity=20, frames=jnp.asarray(frames))
    p_lo, p_c = port.prefill(torch.from_numpy(toks), capacity=20,
                             frames=torch.from_numpy(frames))
    np.testing.assert_allclose(p_lo.numpy(), np.asarray(r_lo), **TOL)
    for name in ("k", "v", "ck", "cv"):
        assert tuple(p_c[name].shape) == r_c[name].shape, name
        np.testing.assert_allclose(p_c[name].numpy(), np.asarray(r_c[name]), **TOL)
    for name in ("lens", "enc_lens"):
        np.testing.assert_array_equal(p_c[name].numpy(), np.asarray(r_c[name]))
    for _ in range(4):
        t = np.asarray(r_lo).argmax(-1).astype(np.int32)
        assert (p_lo.numpy().argmax(-1) == t).all()
        r_lo, r_c = ref.decode(params, jnp.asarray(t), r_c)
        p_lo, p_c = port.decode(torch.from_numpy(t), p_c)
        np.testing.assert_allclose(p_lo.numpy(), np.asarray(r_lo), **TOL)


def test_contiguous_families_engine_seamless(pair):
    """The reference test's seamless case on the port: one request with 6
    frames through the contiguous engine equals the reference model's own
    prefill + greedy decode."""
    ref, params, tree, _ = pair
    rng = np.random.default_rng(0)
    fr = rng.normal(size=(6, CFG.d_model)).astype(np.float32)
    p = list(map(int, rng.integers(1, 500, size=8)))
    logits, cache = ref.prefill(params, jnp.asarray([p], jnp.int32), capacity=32,
                                frames=jnp.asarray(fr)[None])
    seq = [int(jnp.argmax(logits[0]))]
    for _ in range(4):
        logits, cache = ref.decode(params, jnp.asarray([seq[-1]], jnp.int32), cache)
        seq.append(int(jnp.argmax(logits[0])))
    eng = NeoEngine(CFG, EngineConfig(max_batch_tokens=64, policy="neo"),
                    params=params_from_reference(tree, CFG), device="cpu")
    try:
        assert not eng.paged
        rid = eng.submit(p, 5, extras={"frames": fr})
        assert eng.run_until_done(100)[rid] == seq
        assert eng.scheduler.policy == "neo"
    finally:
        eng.close()


def test_engine_matches_reference_engine(pair):
    """Three requests with frames of different lengths (each slot's cross
    cache zero-padded to ``encoder_memory_len``, ``enc_lens`` the frames
    given), all prefilled in the first step: tokens and counters equal the
    reference engine's."""
    _, params, tree, _ = pair
    rng = np.random.default_rng(2)
    reqs = [(list(map(int, rng.integers(1, 500, size=n))),
             {"frames": rng.normal(size=(f, CFG.d_model)).astype(np.float32)})
            for n, f in ((9, 6), (14, 11), (6, 32))]
    out = {}
    for side in ("ref", "port"):
        kw = dict(max_batch_tokens=64, policy="neo", hw_profile="h100_sxm", ewma_alpha=0.0)
        if side == "ref":
            eng = RefEngine(ref_smoke(ARCH), RefEngineConfig(**kw), params=params)
        else:
            eng = NeoEngine(CFG, EngineConfig(**kw), params=params_from_reference(tree, CFG),
                            device="cpu")
        try:
            rids = [eng.submit(p, 6, extras=e) for p, e in reqs]
            done = eng.run_until_done(100)
            s = eng.stats
            out[side] = ([done[r] for r in rids], s.iterations, s.prefill_tokens,
                         s.device_decodes, s.tokens_out, s.plans)
        finally:
            eng.close()
    assert out["port"] == out["ref"]
    assert "prefill=3(" in out["port"][-1][0]  # every prefill in the first step
