"""The port's multi-device training (logical-axis sharding on a torch
``DeviceMesh``, ZeRO, the int8 all-reduce, elastic re-meshing,
``launch.train --mesh``, split-K decode) against the JAX package, on the
CPU at the smoke size (fp32).

* Rules, no process group: ``default_rules`` and ``spec`` equal the
  reference's for every arch on stub meshes (16, 16), (4, 2) and
  (2, 16, 16) with pod; every parameter's resolved ``param_logical_axes``
  equals the reference's (its stacked leaves' layer axes dropped); every
  AdamW and Adafactor moment's ZeRO spec equals the reference's choice on
  its stacked leaf.
* Four ``gloo`` ranks, all in ONE module-scoped spawn (one torch thread
  each, every collective under a 60 s timeout), each check's results back
  as JSON or npz, one test per check:
  - on a 2 x 2 (data x model) mesh: the qwen3 (dense) and deepseek (moe)
    loss and gradients against the reference's single-device ones (loss
    rel 1e-5, gradients 1e-5 of the largest entry); 3 AdamW and 3
    Adafactor steps with ZeRO and ``grad_accum=2`` against the port's
    single-device steps (losses, gradient norms and parameters 1e-5),
    every moment laid out by its ZeRO spec;
    ``int8_allreduce_mean`` with a different gradient per data rank
    bitwise its numpy oracle, and with a replicated one bitwise the
    reference's (a subprocess with 4 fake XLA devices, as
    ``tests/conftest.py::run_subprocess`` starts it);
    ``launch.train --mesh --tp 2`` run, then resumed from its checkpoint,
    against the reference's single-device ``launch.train`` from the same
    weights (losses and gradient norms rel 1e-5);
    ``distributed.mesh_check`` (the four-card checks) at the smoke size;
  - on a 1 x 4 mesh, ``decode_attention_blocksharded`` against the
    reference's contiguous oracle with its test's shapes and lengths
    (1e-5), and the dense decode's ``kv_shard_mode="blocks"`` branch
    against one device's decode (1e-5);
  - serving on a mesh against the same weights with no context: a prefill
    of 4 x 16 tokens (the flash kernel's wrapper, the scans' on each rank's
    block) and 3 decode steps, every step's logits within 1e-5, for qwen3
    (GQA: K/V projected per query head on 2 x 2 and 1 x 4; KV heads
    sharded; one KV head), deepseek (MHA, MoE), rwkv6 and zamba2 on 2 x 2;
  - the blocks each rank attends or scans when an axis does not divide:
    6 query heads on a model axis of 4 (a rank with none), forward and
    gradients, and one batch row over two data ranks through both scans,
    against the whole tensors (1e-5);
  - rwkv6 and zamba2 training on 2 x 2 (the scans through ``on_blocks``)
    against the no-context loss (rel 1e-5) and gradients
    (``SSM_GRAD_TOL`` of the largest entry);
  - last, elastic: drop data replica 1 of 2; the survivors' trimmed-batch
    losses equal the single-device losses on the same rows, two
    ``relower_events``, and the dropped ranks leave the loop and exit 0.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.distributed import zero as ref_zero  # noqa: E402
from repro.launch import train as ref_launch  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train.optimizer import adafactor_init as ref_adafactor_init  # noqa: E402
from repro.train.optimizer import adamw_init as ref_adamw_init  # noqa: E402
from tests.conftest import SRC  # noqa: E402

from repro_torch.testing import one_thread, spawn_gloo  # noqa: E402,F401
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.distributed.collectives import int8_allreduce_mean  # noqa: E402
from repro_torch.distributed import mesh_check  # noqa: E402
from repro_torch.distributed.elastic import ElasticRunner, initial_topology, reshard_batch  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingContext,
    StubMesh,
    activate,
    current_context,
    default_rules,
    distribute_params,
    spec_placements,
)
from repro_torch.distributed.zero import zero_spec_for, zero_specs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import mamba2 as mamba2_lib  # noqa: E402
from repro_torch.models import rwkv6 as rwkv6_lib  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import params_to_reference, reference_leaves  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.optimizer import adafactor_init, adamw_init  # noqa: E402
from repro_torch.train.trainer import trainable, value_and_grad  # noqa: E402

WORLD = 4
TIMEOUT_S = 60
MESHES = {"16x16": (("data", "model"), (16, 16)), "4x2": (("data", "model"), (4, 2)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
LOSS_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b")
SSM_ARCHS = ("rwkv6-7b", "zamba2-7b")
# The chunked scans' backward amplifies float order: moving rwkv6's ``wo`` by
# one part in 1e7 moves ``u``'s gradient by 2.8e-5 of the largest entry, and
# a mesh's other summation order reaches 8.6e-5 (rwkv6) and 5.7e-5 (zamba2)
# of it.  The wrong layout of B and C's gradient this check was written
# for was 0.67 of it.
SSM_GRAD_TOL = 2e-4
SERVE_TOL = 1e-5
SERVE_STEPS = 3
SERVE_CASES = {  # name: (arch, mesh, config overrides)
    "qwen3-0.6b-2x2": ("qwen3-0.6b", (2, 2), {}),  # K/V per query head (kv_follow)
    "qwen3-0.6b-1x4": ("qwen3-0.6b", (1, 4), {}),  # one query head a rank
    "qwen3-0.6b-kv-heads-2x2": ("qwen3-0.6b", (2, 2), {"kv_shard_mode": "heads"}),
    "qwen3-0.6b-one-kv-head-2x2": ("qwen3-0.6b", (2, 2), {"num_kv_heads": 1}),
    "deepseek-moe-16b-2x2": ("deepseek-moe-16b", (2, 2), {}),
    "rwkv6-7b-2x2": ("rwkv6-7b", (2, 2), {}),
    "zamba2-7b-2x2": ("zamba2-7b", (2, 2), {}),
}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of the largest gradient entry
TRAJ_TOL = 1e-5
LAUNCH_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "10", "--ckpt-every", "4",
               "--seq", "32"]


# ---------------------------------------------------------------------------
# rules, specs and ZeRO specs on stub meshes (no process group)
# ---------------------------------------------------------------------------


class _RefStub:
    """The reference tests' minimal mesh stub."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _meshes(key):
    names, sizes = MESHES[key]
    return _RefStub(names, sizes), StubMesh(names, sizes)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _ref_axes_by_port_name(arch):
    """{port name: (the reference's logical axes of its stacked leaf, the
    number of stacked leading axes)}."""
    cfg = get_smoke_config(arch)
    names = dict(get_model(cfg, device="cpu").named_parameters())
    ref_axes = dict(_flat(ref_get_model(ref_smoke(arch)).param_logical_axes()))
    out = {}
    for path, lead, group in reference_leaves(names, cfg):
        for n in group:
            out[n] = (ref_axes[path], len(lead))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_and_specs_equal_reference(mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    logicals = [("batch", "seq", None), ("batch", "heads", "d_ff"), ("batch", None, "vocab"),
                ("vocab", None), (None, "kv_heads", None), ("experts", None, "expert_ff"),
                ("layers", "batch", "kv_seq", "kv_heads", None), ("batch", "experts", None, None),
                (None, "batch"), ("d_ff", "heads", "vocab", "experts")]
    for arch in ARCH_NAMES:
        ref_cfg, cfg = ref_config(arch), get_config(arch)
        assert default_rules(cfg, port_mesh) == ref_sharding.default_rules(ref_cfg, ref_mesh)
        ref_ctx = ref_sharding.ShardingContext.for_arch(ref_cfg, ref_mesh)
        ctx = ShardingContext.for_arch(cfg, port_mesh)
        assert ctx.rules == ref_ctx.rules, arch
        for logical in logicals:
            got = ctx.spec(logical)
            assert P(*got) == ref_ctx.spec(logical), (arch, logical, got)
    # the reference's dedupe and tuple-preserving rules
    ctx = ShardingContext.for_arch(get_config("qwen3-32b"), port_mesh)
    batch = ("pod", "data") if "pod" in port_mesh.mesh_dim_names else ("data",)
    assert ctx.spec(("batch", "heads", "d_ff")) == (batch, "model", None)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b", "llama4-maverick-400b-a17b",
                                  "internvl2-1b", "rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_param_logical_axes_resolve_as_reference(arch):
    want = _ref_axes_by_port_name(arch)
    axes = get_model(get_smoke_config(arch), device="cpu").param_logical_axes()
    assert set(axes) == set(want)
    for mesh in MESHES:
        ref_mesh, port_mesh = _meshes(mesh)
        ref_ctx = ref_sharding.ShardingContext.for_arch(ref_config(arch), ref_mesh)
        ctx = ShardingContext.for_arch(get_config(arch), port_mesh)
        for name, (ref_ax, lead) in want.items():
            assert ref_ax[:lead] == (None,) * lead, (name, ref_ax)
            assert axes[name] == ref_ax[lead:], (name, axes[name], ref_ax)
            ref_spec = tuple(ref_ctx.spec(ref_ax)) + (None,) * len(ref_ax)
            assert P(*ctx.spec(axes[name])) == P(*ref_spec[lead:len(ref_ax)]), (mesh, name)


def _ref_zero_specs(arch, opt, ref_mesh):
    """{(moment, reference path...): the reference's ZeRO spec} from its
    ``zero_shard_opt_state``'s own rule, on shapes alone."""
    model = ref_get_model(ref_smoke(arch))
    init = ref_adamw_init if opt == "adamw" else ref_adafactor_init
    state = jax.eval_shape(init, model.param_specs())
    ctx = ref_sharding.ShardingContext.for_arch(ref_smoke(arch), ref_mesh)
    axes = model.param_logical_axes()
    out = {}

    def one(path, leaf):
        spec = ref_zero._spec_from_path(path, axes, ctx)
        if spec is None or len(spec) != leaf.ndim:
            spec = P(*[None] * leaf.ndim)
        key = tuple(str(getattr(k, "key", k)) for k in path)
        out[key] = (ref_zero.zero_spec_for(spec, leaf.shape, ctx.mesh), leaf.shape)

    jax.tree_util.tree_map_with_path(one, state)
    return out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_zero_specs_equal_reference(opt):
    """Every moment of every leaf: the port decides on the reference's
    stacked shape and keeps the reference's choice on its own dims (a
    choice of the stacked layer axis leaves the per-layer moment
    replicated over data).  Some moments do shard over data."""
    sharded = 0
    for arch in ("qwen3-0.6b", "deepseek-moe-16b", "rwkv6-7b", "zamba2-7b"):
        cfg = get_smoke_config(arch)
        model = get_model(cfg, device="cpu")
        params = dict(model.named_parameters())
        state = (adamw_init if opt == "adamw" else adafactor_init)(params)
        leaves = {n: (path, len(lead)) for path, lead, g in reference_leaves(params, cfg)
                  for n in g}
        for mesh in ("16x16", "4x2"):
            ref_mesh, port_mesh = _meshes(mesh)
            want = _ref_zero_specs(arch, opt, ref_mesh)
            got = zero_specs(state, model.param_logical_axes(),
                             ShardingContext.for_arch(cfg, port_mesh), cfg)
            for part, tree in got.items():
                for name, spec in tree.items():
                    path, lead = leaves[name]
                    for sub, s in (spec.items() if isinstance(spec, dict) else [(None, spec)]):
                        key = (part,) + path + ((sub,) if sub else ())
                        ref_spec, _ = want[key]
                        ref_t = tuple(ref_spec) + (None,) * (lead + len(s) - len(ref_spec))
                        assert P(*s) == P(*ref_t[lead:]), (arch, mesh, key, s, ref_spec)
                        sharded += "data" in s
    assert sharded
    # the reference's own cases
    m = StubMesh(("data", "model"), (16, 16))
    assert zero_spec_for((None, "model"), (4096, 1024), m) == ("data", "model")
    assert zero_spec_for((None,), (17,), m) == (None,)


# ---------------------------------------------------------------------------
# the four-rank run: every multi-process check in one spawn
# ---------------------------------------------------------------------------


def _batch_np(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size - 12, size=(rows, 32)).astype(np.int32),
            "targets": rng.integers(1, cfg.vocab_size - 12, size=(rows, 32)).astype(np.int32),
            "loss_mask": np.ones((rows, 32), np.float32)}


def _state(arch, seed=0):
    model = get_model(get_smoke_config(arch), device="cpu")
    return {k: v.detach().clone() for k, v in
            model.init(torch.Generator().manual_seed(seed)).state_dict().items()}


def _model(cfg, state):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _mesh22():
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _check_loss(rank, out, arch):
    cfg = get_smoke_config(arch)
    state = torch.load(out / f"{arch}.pt")
    model = _model(cfg, state)
    ctx = ShardingContext.for_arch(cfg, _mesh22())
    with activate(ctx):
        distribute_params(model, ctx)
        batch = {k: ctx.distribute(torch.from_numpy(v), ("batch", None))
                 for k, v in _batch_np(cfg, 8, 1).items()}
        loss, _, grads = value_and_grad(model, trainable(model), batch)
        full = {k: _full(g.redistribute(g.device_mesh, model.get_parameter(k).placements))
                for k, g in grads.items()}
        loss = _full(loss)
    if rank == 0:
        torch.save({"loss": loss, "grads": full}, out / f"loss_{arch}.pt")
    return {"placements": {k: str(p.placements) for k, p in model.named_parameters()}}


TRAIN_CFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10, grad_accum=2)


def _batches(cfg):
    src = SyntheticTokens(cfg, batch=8, seq_len=32, seed=0)
    return iter(src.batch_at(i) for i in range(3))


def _check_zero(rank, out, opt):
    cfg = get_smoke_config("qwen3-0.6b")
    model = _model(cfg, torch.load(out / "qwen3-0.6b.pt"))
    ctx = ShardingContext.for_arch(cfg, _mesh22())
    with activate(ctx):
        tr = Trainer(model, dataclasses.replace(TRAIN_CFG, optimizer=opt))
        hist = tr.train(_batches(cfg), 3, log_every=1)
        specs = zero_specs(tr.opt_state, model.param_logical_axes(), ctx, cfg)
        wrong = []
        for part in ("m", "v"):
            want = dict(_flat(specs[part]))
            wrong += ["/".join((part,) + k) for k, t in _flat(tr.opt_state[part])
                      if tuple(t.placements) != spec_placements(want[k], ctx.mesh)]
        sharded = sum("data" in s for s in specs["m"].values())
        params = {k: _full(p.detach()) for k, p in tr.params.items()}
    if rank == 0:
        torch.save(params, out / f"zero_{opt}_params.pt")
    return {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
            "wrong": wrong, "sharded": sharded}


def _check_int8(rank, out):
    mesh = _mesh22()
    data = mesh.get_coordinate()[0]
    rng = np.random.default_rng(100 + data)  # one gradient per data rank
    tree = {"g": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
            "h": torch.from_numpy(rng.standard_normal(17).astype(np.float32) * 3)}
    got = int8_allreduce_mean(tree, mesh, ("data",))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32))
    rep = int8_allreduce_mean({"g": x}, mesh, ("data",))["g"]
    if rank == 0:
        torch.save({"diff": got, "rep": rep}, out / "int8.pt")
    return {"sum": float(sum(t.double().sum() for t in got.values()))}


def _check_mesh_check(rank, out):
    """``repro_torch.distributed.mesh_check`` (the four-card checks) at the
    smoke size on the spawn's world."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mesh_check.main(["--smoke", "--device", "cpu", "--layers", "2"])
    return {"rc": rc, "out": buf.getvalue()}


def _check_launch(rank, out):
    argv = LAUNCH_ARGS + ["--device", "cpu", "--mesh", "--tp", "2", "--ckpt", str(out / "ck")]
    texts = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert launch_train.main(argv) == 0
        texts.append(buf.getvalue())
    return {"first": texts[0], "second": texts[1]}


def _blocks_inputs():
    rng = np.random.default_rng(0)
    B, S, KV, H, hd = 4, 32, 2, 4, 16
    f = np.float32
    return (rng.normal(size=(B, H, hd)).astype(f), rng.normal(size=(B, S, KV, hd)).astype(f),
            rng.normal(size=(B, S, KV, hd)).astype(f), rng.normal(size=(B, KV, hd)).astype(f),
            rng.normal(size=(B, KV, hd)).astype(f), np.asarray([3, 17, 31, 8], np.int32))


def _check_blocks(rank, out):
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), kv_shard_mode="blocks")
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    ctx = ShardingContext.for_arch(cfg, mesh)
    assert ctx.rules["kv_seq"] == "model"
    with activate(ctx):
        o, kc, vc = attn_lib.decode_attention_blocksharded(
            *(torch.from_numpy(a) for a in _blocks_inputs()))
        res = {"o": _full(o), "k": _full(kc), "v": _full(vc),
               "placements": str(kc.placements)}
    if rank == 0:
        torch.save(res, out / "blocks.pt")
    return {"placements": res["placements"]}


def _check_decode_blocks(rank, out):
    """The dense decode's ``kv_shard_mode="blocks"`` branch: 4 steps from an
    empty cache on the 1 x 4 mesh (the KV sequence split over the model
    axis) against the same steps on one device."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), kv_shard_mode="blocks")
    model = _model(cfg, torch.load(out / "qwen3-0.6b.pt"))
    tokens = torch.tensor([[5, 9, 17, 3], [7, 7, 1, 2], [400, 3, 3, 8], [1, 2, 3, 4]])
    cache, want = model.init_cache(4, 16), []
    for t in range(4):
        logits, cache = model.decode(tokens[:, t], cache)
        want.append(logits)
    ctx = ShardingContext.for_arch(cfg, init_device_mesh("cpu", (1, 4),
                                                         mesh_dim_names=("data", "model")))
    with activate(ctx):
        distribute_params(model, ctx)
        cache, got = model.init_cache(4, 16), []
        for t in range(4):
            logits, cache = model.decode(tokens[:, t], cache)
            got.append(_full(logits))
    return {"err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "placements": str(cache["k"].placements)}


def _serve(model, tokens):
    """Logits of a prefill and :data:`SERVE_STEPS` decode steps, whole."""
    logits, cache = model.prefill(tokens, capacity=tokens.shape[1] + SERVE_STEPS)
    got = [_full(logits)]
    for t in range(SERVE_STEPS):
        logits, cache = model.decode(torch.arange(tokens.shape[0]) * 7 + 3 + t, cache)
        got.append(_full(logits))
    return got


def _check_serve(rank, out, name):
    arch, shape, over = SERVE_CASES[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = get_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 400, (4, 16)))
    want = _serve(model, tokens)
    ctx = ShardingContext.for_arch(cfg, init_device_mesh("cpu", shape,
                                                         mesh_dim_names=("data", "model")))
    with activate(ctx):
        distribute_params(model, ctx)
        got = _serve(model, ctx.distribute(tokens, ("batch", None)))
    return {"err": [float((a - b).abs().max()) for a, b in zip(got, want)]}


def _check_uneven(rank, out):
    """The per-rank blocks where an axis does not divide the mesh dim."""
    rng = np.random.default_rng(2)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    res = {}
    # 6 query heads on a model axis of 4: blocks of 2, 2, 2 and none
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), num_heads=6)
    ctx = ShardingContext.for_arch(cfg, init_device_mesh("cpu", (1, 4),
                                                         mesh_dim_names=("data", "model")))
    q, k, v, w = rand(2, 8, 6, 16), rand(2, 8, 2, 16), rand(2, 8, 2, 16), rand(2, 8, 6, 16)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    want = attn_lib.chunked_attention(*qkv)
    want_g = torch.autograd.grad((want * w).sum(), qkv)
    with activate(ctx):
        qkv = [ctx.distribute(t.detach(), (None,) * 4).requires_grad_() for t in (q, k, v)]
        o = attn_lib.chunked_attention(*qkv)
        g = torch.autograd.grad((o * ctx.distribute(w, (None, None, "heads", None))).sum(), qkv)
        res["heads"] = max(float((_full(a) - b).abs().max())
                           for a, b in zip([o.detach(), *g], [want.detach(), *want_g]))
    # one batch row over two data ranks: the scans on whole batch blocks
    mesh = _mesh22()
    H, N, P, f = 4, 16, 8, torch.nn.functional.softplus
    cases = {"rwkv6": (rwkv6_lib.scan("kernel"), "rwkv6-7b",
                       [rand(1, 16, H, N) for _ in range(3)]
                       + [torch.sigmoid(rand(1, 16, H, N)), rand(H, N), rand(1, H, N, N)]),
             "mamba2": (mamba2_lib.ssd("kernel"), "zamba2-7b",
                        [rand(1, 16, H, P), f(rand(1, 16, H)), -torch.exp(rand(H)),
                         rand(1, 16, N), rand(1, 16, N), rand(H), rand(1, H, N, P)])}
    for key, (fn, arch, args) in cases.items():
        want = fn(*args)
        ctx = ShardingContext.for_arch(get_smoke_config(arch), mesh)
        with activate(ctx):
            got = fn(*(ctx.distribute(a, (None,) * a.ndim) for a in args))
            res[key] = max(float((_full(a) - b).abs().max()) for a, b in zip(got, want))
    return res


def _check_ssm_loss(rank, out, arch):
    """Training through the scans on each rank's block, against the same
    step with no context."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(cfg, 8, 1).items()}
    want, _, want_g = value_and_grad(model, trainable(model), batch)
    ctx = ShardingContext.for_arch(cfg, _mesh22())
    with activate(ctx):
        distribute_params(model, ctx)
        loss, _, grads = value_and_grad(model, trainable(model), {
            k: ctx.distribute(v, ("batch", None)) for k, v in batch.items()})
        grads = {k: _full(g.redistribute(g.device_mesh, model.get_parameter(k).placements))
                 for k, g in grads.items()}
        loss = float(_full(loss))
    return {"loss": loss, "want": float(want),
            "grad_err": max(float((grads[k] - g).abs().max()) for k, g in want_g.items()),
            "scale": max(float(g.abs().max()) for g in want_g.values())}


def _check_elastic(rank, out):
    cfg = get_smoke_config("qwen3-0.6b")
    state = torch.load(out / "qwen3-0.6b.pt")

    def factory(cfg_, mesh):
        model = _model(cfg_, state)
        distribute_params(model, current_context())
        return lambda batch: model.loss(batch)[0]

    runner = ElasticRunner(cfg, factory, initial_topology(model_axis=2))
    batch = _batch_np(cfg, 7, 3)
    res = {"data0": runner.topo.data}
    res["l0"] = float(_full(runner.run(reshard_batch(batch, runner.topo))))
    runner.on_failure(replica=1)  # the host of ranks 2 and 3 died
    res.update(member=runner.member, data1=runner.topo.data)
    if runner.member:
        res["l1"] = float(_full(runner.run(reshard_batch(batch, runner.topo))))
    res["events"] = runner.relower_events
    return res


CHECKS = {
    "loss_qwen3-0.6b": lambda r, o: _check_loss(r, o, "qwen3-0.6b"),
    "loss_deepseek-moe-16b": lambda r, o: _check_loss(r, o, "deepseek-moe-16b"),
    "zero": lambda r, o: _check_zero(r, o, "adamw"),
    "zero_adafactor": lambda r, o: _check_zero(r, o, "adafactor"),
    "int8": _check_int8,
    "launch": _check_launch,
    "blocks": _check_blocks,
    "decode_blocks": _check_decode_blocks,
    "mesh_check": _check_mesh_check,
    **{f"serve_{name}": (lambda r, o, name=name: _check_serve(r, o, name)) for name in SERVE_CASES},
    "uneven": _check_uneven,
    **{f"ssm_loss_{arch}": (lambda r, o, arch=arch: _check_ssm_loss(r, o, arch))
       for arch in SSM_ARCHS},
    "elastic": _check_elastic,  # last: it drops ranks 2 and 3
}


def _rank_main(rank, out):
    out = Path(out)
    results = {}
    for name, check in CHECKS.items():
        try:
            results[name] = check(rank, out)
        except Exception:  # reported by the check's own test
            results[name] = {"error": traceback.format_exc()}
        if name != "elastic":
            dist.barrier()
    (out / f"rank{rank}.json").write_text(json.dumps(results))


def _ref_loss_and_grads(arch, state, batch):
    cfg = get_smoke_config(arch)
    tree = params_to_reference(state, cfg)
    ref = ref_get_model(ref_smoke(arch))
    (loss, _), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {"/".join(p): np.asarray(g) for p, g in _flat(
        jax.tree.map(np.asarray, grads))}


_REF_INT8 = """
import sys, jax, jax.numpy as jnp, numpy as np
from repro.distributed.collectives import int8_allreduce_mean
mesh = jax.make_mesh((2, 2), ('data', 'model'))
x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 32)), jnp.float32)
np.save(sys.argv[1] if len(sys.argv) > 1 else %r,
        np.asarray(int8_allreduce_mean({'g': x}, mesh, ('data',))['g']))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The spawn's per-rank results and files, and the references computed
    in this process while the ranks run."""
    out = tmp_path_factory.mktemp("dist")
    for arch in LOSS_ARCHS:
        torch.save(_state(arch), out / f"{arch}.pt")
    procs = spawn_gloo(_rank_main, WORLD, str(out), timeout_s=TIMEOUT_S)
    ref = {}
    try:
        # the reference's int8 all-reduce on 4 fake XLA devices, as
        # tests/conftest.py::run_subprocess runs it, beside the rest
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
        int8 = subprocess.Popen([sys.executable, "-c", _REF_INT8 % str(out / "ref_int8.npy")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        for arch in LOSS_ARCHS:
            ref[arch] = _ref_loss_and_grads(arch, torch.load(out / f"{arch}.pt"),
                                            _batch_np(get_smoke_config(arch), 8, 1))
        ref["launch"] = _ref_launch(out, torch.load(out / "qwen3-0.6b.pt"))
        log = int8.communicate(timeout=600)[0]
        assert int8.returncode == 0, log
        ref["int8"] = np.load(out / "ref_int8.npy")
    finally:
        while not procs.join():
            pass
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return out, ranks, ref


def _ref_launch(out, state):
    """The reference's single-device ``launch.train`` (twice: run and
    resume) from the port's weights."""
    cfg = get_smoke_config("qwen3-0.6b")
    tree = params_to_reference(state, cfg)
    real = ref_launch.get_model

    def get_model_with_weights(c):
        model = real(c)
        model.init = lambda rng: jax.tree.map(jnp.array, tree)
        return model

    texts = []
    ref_launch.get_model = get_model_with_weights
    try:
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert ref_launch.main(LAUNCH_ARGS + ["--ckpt", str(out / "ref_ck")]) == 0
            texts.append(buf.getvalue())
    finally:
        ref_launch.get_model = real
    return texts


def _entry(run, name, rank=0):
    res = run[1][rank][name]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_mesh_loss_and_grads_match_reference(run, arch):
    out, ranks, ref = run
    _entry(run, f"loss_{arch}")
    want_loss, want = ref[arch]
    got = torch.load(out / f"loss_{arch}.pt")
    assert abs(float(got["loss"]) - want_loss) <= LOSS_RTOL * abs(want_loss)
    cfg = get_smoke_config(arch)
    grads = {"/".join(p): g for p, g in _flat(params_to_reference(got["grads"], cfg))}
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    bad = {k: float(np.abs(grads[k] - want[k]).max()) for k in want
           if np.abs(grads[k] - want[k]).max() > GRAD_TOL * scale}
    assert not bad, (scale, bad)
    # the parameters are laid out by their specs: the vocab and the heads
    # shard over "model"
    pl = ranks[0][f"loss_{arch}"]["placements"]
    assert pl["embed"] == "(Replicate(), Shard(dim=0))"
    assert pl["layers.0.attn.wq"] == "(Replicate(), Shard(dim=1))"


def _assert_zero_trajectory(run, name, opt):
    """3 ZeRO steps with ``grad_accum=2`` on the 2 x 2 mesh: every moment
    laid out by its ZeRO spec; losses, global gradient norms (the clip's
    and Adafactor's update scale) and parameters those of one device."""
    out, _, _ = run
    res = _entry(run, name)
    assert not res["wrong"] and res["sharded"] > 0, res
    cfg = get_smoke_config("qwen3-0.6b")
    tr = Trainer(_model(cfg, torch.load(out / "qwen3-0.6b.pt")),
                 dataclasses.replace(TRAIN_CFG, optimizer=opt))
    hist = tr.train(_batches(cfg), 3, log_every=1)
    np.testing.assert_allclose(res["losses"], [h["loss"] for h in hist], rtol=TRAJ_TOL)
    np.testing.assert_allclose(res["grad_norms"], [h["grad_norm"] for h in hist], rtol=TRAJ_TOL)
    got = torch.load(out / f"zero_{opt}_params.pt")
    worst = max(float((got[k] - p.detach()).abs().max()) for k, p in tr.params.items())
    assert worst <= TRAJ_TOL, worst


def test_zero_trajectory_matches_single_device(run):
    _assert_zero_trajectory(run, "zero", "adamw")


def test_zero_adafactor_trajectory_matches_single_device(run):
    _assert_zero_trajectory(run, "zero_adafactor", "adafactor")


def _int8_oracle(grads, n):
    scale = np.float32(max(np.abs(g).max() for g in grads)) / np.float32(127.0) + np.float32(1e-12)
    s = sum(np.clip(np.rint(g / scale), -127, 127).astype(np.int8).astype(np.int32)
            for g in grads)
    return (s.astype(np.float32) * scale / np.float32(n)).astype(np.float32)


def test_int8_allreduce_mean_bitwise(run):
    out, ranks, ref = run
    _entry(run, "int8")
    # every rank holds the same result
    assert len({r["int8"]["sum"] for r in ranks}) == 1
    got = torch.load(out / "int8.pt")
    for k, shape, mult in (("g", (64, 32), 1.0), ("h", (17,), 3.0)):
        grads = []
        for data in range(2):
            rng = np.random.default_rng(100 + data)
            g = rng.standard_normal((64, 32)).astype(np.float32)
            h = rng.standard_normal(17).astype(np.float32) * np.float32(3)
            grads.append(g if k == "g" else h)
        want = _int8_oracle(grads, 2)
        assert np.array_equal(got["diff"][k].numpy(), want), k
    # replicated input: the reference's result, bit for bit
    assert np.array_equal(got["rep"].numpy(), ref["int8"])


def test_launch_train_mesh_resumes_as_reference(run):
    res = _entry(run, "launch")
    ref_first, ref_second = run[2]["launch"]
    for got, want in ((res["first"], ref_first), (res["second"], ref_second)):
        g_lines, w_lines = got.splitlines(), want.splitlines()
        assert len(g_lines) == len(w_lines), (got, want)
        for g, w in zip(g_lines, w_lines):
            if g.startswith("[train]"):
                assert g == w
                continue
            g, w = json.loads(g), json.loads(w)
            assert g["step"] == w["step"] and set(g) == set(w)
            assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (g, w)
            assert abs(g["grad_norm"] - w["grad_norm"]) <= LOSS_RTOL * abs(w["grad_norm"]), (g, w)
            assert abs(g["lr"] - w["lr"]) <= 1e-7
    assert res["second"].splitlines()[0] == "[train] resumed from step 8"
    # the other ranks print nothing
    assert all(r["launch"]["first"] == "" for r in run[1][1:])


def test_mesh_check_passes(run):
    """The four-card checks' module on the spawn's 2 x 2 world at the smoke
    size: rank 0 prints its three checks, each ok (loss and gradients, and
    the ZeRO step's loss and gradient norm, against one device; elastic),
    and the ZeRO layout takes less AdamW state a rank."""
    res = _entry(run, "mesh_check")
    lines = [json.loads(line) for line in res["out"].splitlines()]
    assert res["rc"] == 0 and [r["mesh_check"] for r in lines] == ["loss", "zero", "elastic"]
    assert all(r["ok"] and r["mesh"] == [2, 2] for r in lines), lines
    assert lines[1]["adamw_bytes_per_rank_zero"] < lines[1]["adamw_bytes_per_rank_no_zero"]
    assert all(run[1][r]["mesh_check"] == {"rc": 0, "out": ""} for r in range(1, WORLD))


def test_blocksharded_decode_matches_reference(run):
    out, _, _ = run
    _entry(run, "blocks")
    q, kc, vc, kn, vn, lens = _blocks_inputs()
    kc2, vc2 = ref_attn.write_kv(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(lens))
    o2 = ref_attn.decode_attention(jnp.asarray(q), kc2, vc2, jnp.asarray(lens) + 1)
    got = torch.load(out / "blocks.pt")
    # the KV sequence over "model" (the batch over "data", of one rank)
    assert got["placements"] == "(Replicate(), Shard(dim=1))"
    np.testing.assert_allclose(got["o"].numpy(), np.asarray(o2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["k"].numpy(), np.asarray(kc2), atol=0, rtol=0)
    np.testing.assert_allclose(got["v"].numpy(), np.asarray(vc2), atol=0, rtol=0)


def test_decode_blocks_branch_matches_single_device(run):
    for rank in range(WORLD):
        res = _entry(run, "decode_blocks", rank)
        assert res["err"] <= 1e-5, res
        # the cache's sequence axis over "model"
        assert res["placements"] == "(Replicate(), Shard(dim=2))"


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_mesh_serve_matches_no_context(run, name):
    """A prefill and 3 decode steps on the mesh give every rank the logits
    of the same steps with no context."""
    for rank in range(WORLD):
        res = _entry(run, f"serve_{name}", rank)
        assert len(res["err"]) == SERVE_STEPS + 1 and max(res["err"]) <= SERVE_TOL, res


@pytest.mark.parametrize("part", ["heads", "rwkv6", "mamba2"])
def test_uneven_blocks_match_whole(run, part):
    for rank in range(WORLD):
        assert _entry(run, "uneven", rank)[part] <= SERVE_TOL


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mesh_ssm_loss_and_grads_match_no_context(run, arch):
    for rank in range(WORLD):
        res = _entry(run, f"ssm_loss_{arch}", rank)
        assert abs(res["loss"] - res["want"]) <= LOSS_RTOL * abs(res["want"]), res
        assert res["grad_err"] <= SSM_GRAD_TOL * res["scale"], res


def test_elastic_drop_replica(run):
    """Drop data replica 1 of 2 (ranks 2 and 3): the survivors re-mesh
    (two relower events) and their trimmed batch's loss is the
    single-device loss on the same rows; the dropped ranks leave the loop
    and exited 0 (the spawn joined)."""
    out = run[0]
    cfg = get_smoke_config("qwen3-0.6b")
    model = _model(cfg, torch.load(out / "qwen3-0.6b.pt"))
    batch = _batch_np(cfg, 7, 3)
    with torch.no_grad():
        want = [float(model.loss({k: torch.from_numpy(v[:rows]) for k, v in batch.items()})[0])
                for rows in (6, 7)]
    for rank in range(WORLD):
        res = _entry(run, "elastic", rank)
        assert res["data0"] == 2 and res["data1"] == 1
        assert abs(res["l0"] - want[0]) <= LOSS_RTOL * abs(want[0])
        assert res["member"] == (rank < 2)
        if rank < 2:
            assert abs(res["l1"] - want[1]) <= LOSS_RTOL * abs(want[1])
            assert [(e["generation"], e["data"], e["model"]) for e in res["events"]] == \
                [(0, 2, 2), (1, 1, 2)]
            assert set(res["events"][-1]) == {"generation", "data", "model", "relower_s"}
        else:
            assert "l1" not in res and len(res["events"]) == 1
