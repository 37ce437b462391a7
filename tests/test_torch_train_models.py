"""The port's training losses and optimizers against the JAX package's, on
the CPU at the smoke size (fp32), weights carried over through
``models/bridge.py``:

* every family's ``loss`` and its gradient per parameter against
  ``jax.value_and_grad(model.loss)`` on the same batch (the reference's
  ``SyntheticTokens``, with a vlm's ``patch_embeds`` and an
  encoder-decoder's ``frames``): loss within rel 1e-5, each leaf's gradient
  within 1e-4 of the largest gradient entry of any leaf, deepseek's aux loss
  within rel 1e-5;
* ``remat_policy`` "none", "full" and "minimal" give bitwise the same loss
  and gradients;
* AdamW and Adafactor updates and new states against the reference's on
  the same parameters, gradients and state (the state carried over by
  ``opt_state_from_reference``), within 1e-6 of each leaf's largest entry,
  Adafactor's bfloat16 first moment bitwise in all but at most 1e-4 of its
  entries, those one bf16 ulp apart (see the test); ``lr_schedule``,
  ``clip_by_global_norm`` and ``int8_roundtrip`` (bitwise).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.distributed.collectives import int8_roundtrip as ref_int8  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import as_tensors  # noqa: E402
from repro_torch.distributed.collectives import int8_roundtrip  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    load_reference_params,
    opt_state_from_reference,
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
    reference_stacks,
)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import trainable, value_and_grad  # noqa: E402

FAMILIES = ["qwen3-0.6b", "deepseek-moe-16b", "internvl2-1b", "rwkv6-7b", "zamba2-7b",
            "seamless-m4t-medium"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the largest gradient entry of any leaf


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float32)


def _batch(cfg, seed=1):
    return RefTokens(cfg, batch=2, seq_len=32, seed=seed).batch_at(0)


def _random_tree(arch, seed):
    """Random weights of the smoke config (the port's init, which skips the
    reference's slow eager init) as a reference tree of numpy arrays."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    return params_to_reference(dict(model.named_parameters()), cfg)


def _port_grads(cfg, tree, batch):
    model = load_reference_params(get_model(cfg, device="cpu"), tree)
    loss, aux, grads = value_and_grad(model, trainable(model), as_tensors(batch))
    return loss, aux, grads


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, one_thread):
    """(arch, the reference's tree, its loss, aux and gradients, the batch,
    the port's loss, aux and gradients under the smoke config's
    ``remat_policy`` "none"), the reference's value_and_grad compiled once
    per family."""
    arch = request.param
    ref = ref_get_model(ref_smoke(arch))
    tree = _random_tree(arch, 0)
    batch = _batch(ref.cfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return (arch, tree, float(loss), float(aux["aux"]),
            dict(_leaves(jax.tree.map(np.asarray, grads))), batch,
            _port_grads(get_smoke_config(arch), tree, batch))


def test_loss_and_grads_match_reference(family):
    arch, tree, want_loss, want_aux, want_grads, batch, port = family
    cfg = get_smoke_config(arch)
    assert cfg.remat_policy == "none"
    loss, aux, grads = port
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss), (float(loss), want_loss)
    if arch == "deepseek-moe-16b":
        assert want_aux > 0
        assert abs(float(aux["aux"]) - want_aux) <= LOSS_RTOL * want_aux
    got = dict(_leaves(params_to_reference(grads, cfg)))
    assert set(got) == set(want_grads)
    scale = max(np.abs(g).max() for g in want_grads.values())
    worst = {k: float(np.abs(got[k] - want_grads[k]).max()) for k in got}
    bad = {k: e for k, e in worst.items() if e > GRAD_TOL * scale}
    assert not bad, (scale, bad)


@pytest.mark.parametrize("policy", ["full", "minimal"])
def test_remat_bitwise(family, policy):
    arch, tree, _, _, _, batch, (l0, a0, g0) = family
    cfg = get_smoke_config(arch)
    l1, a1, g1 = _port_grads(dataclasses.replace(cfg, remat_policy=policy), tree, batch)
    assert torch.equal(l0, l1) and torch.equal(a0["aux"], a1["aux"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_sp_save_equals_full_bitwise(family, monkeypatch):
    """``"sp_save"`` is ``"full"`` that saves the tagged q/k/v: the same
    loss and gradients bit for bit, with no mesh; the tag runs only under
    it, in checkpointed bodies that hold attention (not rwkv6's, nor
    zamba2's Mamba blocks: its shared attention is not checkpointed)."""
    from repro_torch.models import layers

    arch, tree, _, _, _, batch, _ = family
    cfg = get_smoke_config(arch)
    calls = []
    op = layers._sp_gathered
    monkeypatch.setattr(layers, "_sp_gathered", lambda x: calls.append(1) or op(x))
    l0, a0, g0 = _port_grads(dataclasses.replace(cfg, remat_policy="full"), tree, batch)
    assert not calls
    l1, a1, g1 = _port_grads(dataclasses.replace(cfg, remat_policy="sp_save"), tree, batch)
    assert torch.equal(l0, l1) and torch.equal(a0["aux"], a1["aux"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert bool(calls) == (arch not in ("rwkv6-7b", "zamba2-7b")), len(calls)


def test_sp_save_matches_reference():
    """The port's ``"sp_save"`` against the reference's, which runs with no
    mesh too: the tolerances of :func:`test_loss_and_grads_match_reference`."""
    arch = "qwen3-0.6b"
    ref = ref_get_model(ref_smoke(arch).replace(remat_policy="sp_save"))
    tree = _random_tree(arch, 2)
    batch = _batch(ref.cfg)
    (want, _), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads = dict(_leaves(jax.tree.map(np.asarray, grads)))
    cfg = dataclasses.replace(get_smoke_config(arch), remat_policy="sp_save")
    loss, _, port = _port_grads(cfg, tree, batch)
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    got = dict(_leaves(params_to_reference(port, cfg)))
    scale = max(np.abs(g).max() for g in want_grads.values())
    bad = {k: float(np.abs(got[k] - want_grads[k]).max()) for k in got
           if np.abs(got[k] - want_grads[k]).max() > GRAD_TOL * scale}
    assert not bad, (scale, bad)


# ---------------------------------------------------------------------------
# optimizers on identical inputs
# ---------------------------------------------------------------------------

OPT_CFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)


def _tree_like(tree, seed, scale=1.0, square=False):
    rng = np.random.default_rng(seed)

    def draw(a):
        x = rng.standard_normal(np.shape(a)).astype(np.float32) * scale
        return np.abs(x) if square else x

    return jax.tree.map(draw, tree)


@pytest.fixture(scope="module")
def opt_setup():
    return ref_smoke("qwen3-0.6b"), _random_tree("qwen3-0.6b", 1)


def _close(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-6 * max(np.abs(want[k]).max(), 1e-30), (what, k, err)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(opt_setup, name):
    cfg, params = opt_setup
    port_cfg = get_smoke_config("qwen3-0.6b")
    ref_init, ref_update = ref_opt.OPTIMIZERS[name]
    init, update = opt.OPTIMIZERS[name]
    rtc, tc = RefTrainConfig(**OPT_CFG), TrainConfig(**OPT_CFG)
    upd = jax.jit(ref_update, static_argnums=4)
    # one reference step from zeros gives a state with every moment set
    state = ref_init(params)
    _, state = upd(_tree_like(params, 2), state, params, jnp.int32(2), rtc)
    grads = _tree_like(params, 3, scale=0.1)
    want_u, want_state = upd(grads, state, params, jnp.int32(3), rtc)

    p_params = params_from_reference(params, port_cfg)
    p_state = opt_state_from_reference(jax.tree.map(np.asarray, state), port_cfg)
    assert set(jax.tree.leaves(jax.tree.map(lambda t: t.dtype, p_state))) == (
        {torch.float32, torch.bfloat16} if name == "adafactor" else {torch.float32})
    assert opt.adamw_init(p_params).keys() == p_state.keys()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, init(p_params))) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, p_state))
    stacks = reference_stacks(p_params, port_cfg)
    assert len(stacks) == len(jax.tree.leaves(params))
    got_u, got_state = update(params_from_reference(grads, port_cfg), p_state, p_params, 3, tc,
                              stacks)
    _close(params_to_reference(got_u, port_cfg), jax.tree.map(np.asarray, want_u), "updates")
    back = opt_state_to_reference(got_state, port_cfg)
    want_state = jax.tree.map(np.asarray, want_state)
    _close(back["v"], want_state["v"], "v")
    if name == "adafactor":
        # The bf16 first moment: bitwise but where its float32 value falls
        # within the reductions' rounding (the row/column means, the update
        # clip's RMS: XLA's summation order is not torch's) of a bf16
        # rounding boundary (11 of 656,768 entries in this test); there the two are
        # one bf16 step apart, or, near zero, within the float32 tolerance.
        got_m, want_m = dict(_leaves(back["m"])), dict(_leaves(want_state["m"]))
        differ = sum(int((got_m[k] != want_m[k]).sum()) for k in want_m)
        assert differ <= 1e-4 * sum(m.size for m in want_m.values()), differ
        for k, want in want_m.items():
            step = 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max()
            assert (np.abs(got_m[k] - want) <= step).all(), k
        assert any(isinstance(v, dict) and set(v) == {"row", "col"}
                   for v in got_state["v"].values())
    else:
        _close(back["m"], want_state["m"], "m")


def test_opt_state_bridge_round_trip(opt_setup):
    cfg, params = opt_setup
    port_cfg = get_smoke_config("qwen3-0.6b")
    state = jax.tree.map(np.asarray, ref_opt.adafactor_init(params))
    state["v"] = _tree_like(state["v"], 4, square=True)
    back = opt_state_to_reference(opt_state_from_reference(state, port_cfg), port_cfg)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    want = dict(_leaves(state))
    for k, a in _leaves(back):
        assert np.array_equal(a, want[k]), k


@pytest.mark.parametrize("step", [0, 2, 6, 10])
def test_lr_schedule_matches_reference(step):
    # warmup start, the end of warmup, mid-decay, total
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    want = np.float32(ref_opt.lr_schedule(RefTrainConfig(**dataclasses.asdict(tc)), step))
    got = opt.lr_schedule(tc, step)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32) * 3,
            "b": rng.standard_normal(11).astype(np.float32)}
    ref_tree = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    want, want_norm = ref_opt.clip_by_global_norm(ref_tree, 1.0)
    port_tree = {k: torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, dtype))
                 for k, v in ref_tree.items()}
    got, norm = opt.clip_by_global_norm(port_tree, 1.0)
    assert abs(float(norm) - float(want_norm)) <= 1e-6 * float(want_norm)
    assert float(norm) > 1.0  # the clip scales
    for k in tree:
        assert got[k].dtype == port_tree[k].dtype
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                   rtol=1e-6 if dtype == "float32" else 1e-2, atol=0)


def test_int8_roundtrip_bitwise():
    rng = np.random.default_rng(6)
    tree = {"g": rng.standard_normal((33, 17)).astype(np.float32),
            # scale 1 (127 / 127; the 1e-12 is below its ulp): exact halves
            # of the step, rounded half to even
            "h": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)}
    want = ref_int8({k: jnp.asarray(v) for k, v in tree.items()})
    got = int8_roundtrip({k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
