"""The port's MoE FFN, the moe / vlm decoders and the int8 KV cache against
the JAX package's, in fp32 at smoke size with the same weights on both sides
(through the bridge for the models)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import MoEConfig as RefMoEConfig  # noqa: E402
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import active_param_count, get_model, param_count  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_reference_params,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.transformer import layer_pattern, quantize_kv  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)

# (experts, top_k, shared experts, capacity factor, dispatch): deepseek-like
# top-6 with shared experts, llama4's top-1, and a capacity that drops slots
MOE_CASES = {
    "top6-shared-scatter": (16, 6, 2, 1.25, "scatter"),
    "top6-shared-dense": (16, 6, 2, 1.25, "dense"),
    "top6-noshared-scatter": (16, 6, 0, 1.25, "scatter"),
    "top1-shared-scatter": (8, 1, 1, 1.25, "scatter"),
    "top1-noshared-dense": (8, 1, 0, 1.25, "dense"),
    "top6-drop-scatter": (16, 6, 1, 0.5, "scatter"),
    "top6-drop-dense": (16, 6, 1, 0.5, "dense"),
}
D, FF = 32, 24


def _moe_pair(case):
    E, k, shared, cf, dispatch = MOE_CASES[case]
    kw = dict(num_experts=E, top_k=k, expert_d_ff=FF, num_shared_experts=shared,
              shared_d_ff=FF, capacity_factor=cf, dispatch=dispatch)
    ref_cfg = RefMoEConfig(**kw)
    init = jax.jit(ref_moe.moe_params, static_argnums=(1, 2, 3))
    p = jax.tree.map(np.asarray, init(jax.random.key(3), D, ref_cfg, jnp.float32))
    port = moe.MoE(D, MoEConfig(**kw), torch.float32, "cpu")
    with torch.no_grad():
        for name, t in port.named_parameters():
            node = p
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(np.array(node)))
    return ref_cfg, p, port


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    ref_cfg, p, port = _moe_pair(case)
    x = np.random.default_rng(0).normal(size=(3, 20, D)).astype(np.float32)
    y_ref, aux_ref = jax.jit(ref_moe.moe_apply, static_argnums=2)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), ref_cfg)
    y, aux = moe.moe_apply(port, torch.from_numpy(x), port.cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), **MOE_TOL)
    if "drop" in case:  # capacity factor 0.5: some slot lies past the capacity
        _, idx, _ = moe._route(port, torch.from_numpy(x), port.cfg)
        _, _, keep = moe._slot_positions(idx, port.cfg, moe._capacity(20, port.cfg))
        assert (~keep).sum() > 10


@pytest.mark.parametrize("case", ["top6-shared-scatter", "top1-shared-scatter",
                                  "top6-drop-scatter"])
def test_moe_scatter_equals_dense_dispatch(case):
    _, _, port = _moe_pair(case)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 17, D)).astype(np.float32))
    y_s, _ = moe.moe_apply_scatter(port, x, port.cfg)
    y_d, _ = moe.moe_apply_dense(port, x, port.cfg)
    np.testing.assert_allclose(y_s.numpy(), y_d.numpy(), **MOE_TOL)


# ---------------------------------------------------------------------------
# the decoders of the moe and vlm families
# ---------------------------------------------------------------------------

ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b", "internvl2-1b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref = ref_get_model(ref_smoke(arch))
    params = jax.jit(ref.init)(jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    port = get_model(get_smoke_config(arch), device="cpu")
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
    want = dict(_leaves(tree))
    for state in (params_from_reference(tree, port.cfg), dict(port.named_parameters())):
        back = dict(_leaves(params_to_reference(state, port.cfg)))
        assert back.keys() == want.keys()
        for k, a in want.items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)
    prefix, group, n_groups = layer_pattern(port.cfg)
    assert [b.kind for b in port.layers] == prefix + group * n_groups
    assert prefix == (["dense0"] if "deepseek" in port.cfg.name else [])


def _patches(cfg, B, seed):
    P = cfg.modality.num_embeds if cfg.modality is not None else 0
    if not P:
        return None
    return np.random.default_rng(seed).normal(size=(B, P, cfg.d_model)).astype(np.float32)


def test_prefill_and_decode_match_reference(pair):
    """Padded prompts (capacity follows the padded S), a vlm's patches
    replacing the first positions, then greedy decode steps."""
    ref, params, _, port = pair
    cfg = port.cfg
    rng = np.random.default_rng(2)
    lens = np.asarray([27, 32, 19], np.int32)
    toks = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, 500, size=n)
    pe = _patches(cfg, 3, 3)
    kw_r = {} if pe is None else {"patch_embeds": jnp.asarray(pe)}
    kw_p = {} if pe is None else {"patch_embeds": torch.from_numpy(pe)}
    r_logits, r_cache = jax.jit(ref.prefill, static_argnames="capacity")(
        params, jnp.asarray(toks), capacity=40, true_lens=jnp.asarray(lens), **kw_r)
    p_logits, p_cache = port.prefill(torch.from_numpy(toks), capacity=40,
                                     true_lens=torch.from_numpy(lens), **kw_p)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]), **TOL)
    decode = jax.jit(ref.decode)
    for _ in range(4):
        t = np.asarray(r_logits).argmax(-1).astype(np.int32)
        assert (p_logits.numpy().argmax(-1) == t).all()
        r_logits, r_cache = decode(params, jnp.asarray(t), r_cache)
        p_logits, p_cache = port.decode(torch.from_numpy(t), p_cache)
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)


def test_param_counts_match_reference_for_every_config():
    """Total and active counts, full size, every config of the registry
    (the perf model prices every plan from them)."""
    assert sorted(ARCH_NAMES) == sorted(REF_ARCH_NAMES)
    for arch in ARCH_NAMES:
        ref = ref_config(arch)
        cfg = get_config(arch)
        assert param_count(cfg) == ref.param_count(), arch
        assert active_param_count(cfg) == ref.active_param_count(), arch
        assert cfg.active_param_count() == ref.active_param_count(), arch
    assert get_config("deepseek-moe-16b").param_count() == 16_375_728_128
    for arch in ARCHS:  # and the models' own parameters at smoke size
        assert get_model(get_smoke_config(arch), device="cpu").param_count() == \
            ref_get_model(ref_smoke(arch)).param_count(), arch


# ---------------------------------------------------------------------------
# the int8 KV cache (the model's contiguous prefill and decode)
# ---------------------------------------------------------------------------


def test_quantize_kv_codes_and_scales_match_reference():
    rng = np.random.default_rng(4)
    k = (rng.normal(size=(3, 2, 11, 4, 32)) * rng.uniform(0.01, 5, size=(3, 2, 11, 4, 1)))
    v = rng.normal(size=(3, 2, 11, 4, 32)) * 0.3
    k, v = k.astype(np.float32), v.astype(np.float32)
    k[0, 0, 0] = 0.0  # an all-zero row: scale 1e-8, codes 0
    ours = quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    theirs = ref_transformer.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    assert [t.dtype for t in ours] == [torch.int8, torch.int8, torch.float32, torch.float32]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _int8_pair(seed):
    """(the reference's full-precision and int8 models, their weights,
    {"": the port's model, "int8": the port's int8 model}) on one tree."""
    arch = "deepseek-moe-16b"
    ref = ref_get_model(ref_smoke(arch))
    params = jax.jit(ref.init)(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    ref8 = ref_get_model(ref_smoke(arch).replace(kv_cache_dtype="int8", name=arch + "-int8"))
    cfg = get_smoke_config(arch)
    ports = {dt: load_reference_params(
        get_model(cfg.replace(kv_cache_dtype=dt, name=cfg.name + dt), device="cpu"), tree)
        for dt in ("", "int8")}
    return ref, ref8, params, ports


def test_int8_kv_cache_close_to_full_precision():
    """The reference's ``test_int8_kv_cache_close_to_bf16`` scenario on the
    port: greedy decode over the quantised cache agrees with the full
    precision cache on at least 5 of 6 tokens, and the last logits differ by
    less than 0.5."""
    _, _, _, ports = _int8_pair(0)
    m, m8 = ports[""], ports["int8"]
    rng = np.random.default_rng(42)
    p = list(map(int, rng.integers(1, 500, size=14)))
    toks = torch.tensor([p])
    lo, c = m.prefill(toks, capacity=20)
    lo8, c8 = m8.prefill(toks, capacity=20)
    assert c8["k"].dtype == torch.int8 and c8["k_scale"].dtype == torch.float32
    agree = int(int(lo.argmax()) == int(lo8.argmax()))
    for _ in range(5):
        lo, c = m.decode(lo.argmax(-1), c)
        lo8, c8 = m8.decode(lo8.argmax(-1), c8)
        agree += int(int(lo.argmax()) == int(lo8.argmax()))
    assert agree >= 5, f"only {agree}/6 greedy tokens agree"
    assert float((lo - lo8).abs().max()) < 0.5


def test_int8_cache_matches_reference_int8():
    """Port int8 vs reference int8 at the same weights.  The reference's
    own full-precision prefill K/V through the port's quantiser give the
    reference's int8 cache bitwise; the port's prefill (its K/V 1e-4-close)
    gives codes that differ by at most one step where a value lies on a
    rounding boundary, and scales within 1e-5; logits stay within 1e-4
    over decode steps (each side feeds its own argmax; they agree)."""
    ref, ref8, params, ports = _int8_pair(1)
    m8 = ports["int8"]
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 500, size=(2, 14)).astype(np.int32)
    # eager, as the reference's own test runs it: under jit XLA fuses the
    # quantiser into the prefill, and one code of 20,480 lands on the other
    # side of a rounding boundary
    r_lo, r_c = ref8.prefill(params, jnp.asarray(toks), capacity=20)
    _, r_full = ref.prefill(params, jnp.asarray(toks), capacity=20)
    mine = quantize_kv(torch.from_numpy(np.array(r_full["k"])),
                       torch.from_numpy(np.array(r_full["v"])))
    for name, t in zip(("k", "v", "k_scale", "v_scale"), mine):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r_c[name]), err_msg=name)
    p_lo, p_c = m8.prefill(torch.from_numpy(toks), capacity=20)
    np.testing.assert_allclose(p_lo.numpy(), np.asarray(r_lo), **TOL)
    for name in ("k", "v"):
        dq = np.abs(p_c[name].numpy().astype(np.int32) - np.asarray(r_c[name], np.int32))
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-3, name
        np.testing.assert_allclose(p_c[name + "_scale"].numpy(),
                                   np.asarray(r_c[name + "_scale"]), rtol=1e-5)
    decode = jax.jit(ref8.decode)
    for _ in range(4):
        t = np.asarray(r_lo).argmax(-1).astype(np.int32)
        assert (p_lo.numpy().argmax(-1) == t).all()
        r_lo, r_c = decode(params, jnp.asarray(t), r_c)
        p_lo, p_c = m8.decode(torch.from_numpy(t), p_c)
        np.testing.assert_allclose(p_lo.numpy(), np.asarray(r_lo), **TOL)
