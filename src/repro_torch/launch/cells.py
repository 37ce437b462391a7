"""Cell construction for the (architecture × input-shape × mesh) grid, the
port of the JAX package's ``launch/cells.py``.

One "cell" = a step function plus a shape, a dtype and a layout for every
input.  The reference lowers and compiles its step over
``jax.ShapeDtypeStruct`` stand-ins; the port runs its step once on fake
tensors (``FakeTensorMode``: shapes without storage), each input a DTensor
of a fake local block laid out by its spec, inside the counter of
:mod:`repro_torch.roofline.opcount`.

Step kinds per ShapeConfig.kind:
  * train    -> ``train.trainer.make_train_step`` (loss, gradients, the
                optimizer and the ZeRO layout of its state)
  * prefill  -> ``model.prefill``
  * decode   -> ``model.decode`` (one new token over a ``cache_shape``
                cache of ``cache_capacity`` tokens)

Parameters are the model built on the ``meta`` device (the reference's
``param_specs()``).  The port's parameters are per layer where the
reference stacks a leaf over its layers; each spec is the reference's
with the stacked dims dropped (those are never sharded, except where ZeRO
picks one: see ``distributed/zero.py``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import ArchConfig, ShapeConfig, TrainConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed.sharding import (
    ShardingContext,
    Spec,
    activate,
    mesh_sizes,
    spec_placements,
)
from repro_torch.distributed.zero import zero_specs
from repro_torch.models.api import cache_capacity, decode_window, get_model
from repro_torch.train.optimizer import OPTIMIZERS


class Struct(NamedTuple):
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _divides(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else axes
    sizes = mesh_sizes(mesh)
    n = 1
    for a in names:
        n *= sizes.get(a, 1)
    return dim % n == 0


def spec_for_input(ctx: ShardingContext, shape: Tuple[int, ...], logical) -> Spec:
    """Logical axes -> spec, dropping axes that don't divide."""
    full = ctx.spec(logical)
    parts = list(full) + [None] * (len(shape) - len(full))
    out = []
    for dim, part in zip(shape, parts):
        if part is not None and not _divides(dim, ctx.mesh, part):
            part = None
        out.append(part)
    return tuple(out)


def struct_and_sharding(ctx: ShardingContext, shape, dtype, logical) -> Tuple[Struct, Spec]:
    spec = spec_for_input(ctx, tuple(shape), logical)
    return Struct(tuple(shape), torch_dtype(dtype) if isinstance(dtype, str) else dtype), spec


# ---------------------------------------------------------------------------
# params / optimizer-state specs
# ---------------------------------------------------------------------------


def param_structs(model, ctx: ShardingContext) -> Tuple[Dict[str, Struct], Dict[str, Spec]]:
    """({name: Struct}, {name: spec}) of ``model``'s parameters (a model on
    the ``meta`` device allocates nothing)."""
    axes = model.param_logical_axes()
    structs, shards = {}, {}
    for name, p in model.named_parameters():
        ax = axes.get(name)
        shape = tuple(p.shape)
        structs[name] = Struct(shape, p.dtype)
        shards[name] = ((None,) * len(shape) if ax is None or len(ax) != len(shape)
                        else spec_for_input(ctx, shape, ax))
    return structs, shards


def _revalidate(spec: Spec, shape, mesh) -> Spec:
    return tuple(part if _divides(dim, mesh, part) else None
                 for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def opt_structs(model, ctx: ShardingContext, train_cfg: TrainConfig):
    """(structs, specs) of the optimizer state, in its own structure
    (``{"m", "v"}``, each {name: leaf or {"row", "col"}}): each leaf's spec
    is its parameter's, extended by ZeRO over ``data``
    (:func:`repro_torch.distributed.zero.zero_specs`, decided on the
    reference's stacked shapes) and re-validated for divisibility."""
    opt_init, _ = OPTIMIZERS[train_cfg.optimizer]
    state = opt_init(dict(model.named_parameters()))
    specs = zero_specs(state, model.param_logical_axes(), ctx, model.cfg)

    def walk(tree, spec_tree):
        if isinstance(tree, torch.Tensor):
            return (Struct(tuple(tree.shape), tree.dtype),
                    _revalidate(spec_tree, tuple(tree.shape), ctx.mesh))
        pairs = {k: walk(v, spec_tree[k]) for k, v in tree.items()}
        return ({k: s for k, (s, _) in pairs.items()}, {k: sp for k, (_, sp) in pairs.items()})

    return walk(state, specs)


def default_grad_accum(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatching policy for train cells: cap the per-chip microbatch so
    the rematerialised residual stack (≈ L × tokens × d_model × 2 B) stays
    ~2 GB (the reference's policy, kept so that every per-chip count can be
    held to the reference's)."""
    sizes = mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    per_chip_seqs = max(1, shape.global_batch // dp)
    target_tokens = cfg.train_micro_tokens or min(
        16384, (1 << 30) // max(1, cfg.num_layers * cfg.d_model)
    )
    micro_seqs = max(1, min(per_chip_seqs, target_tokens // shape.seq_len))
    # accum must divide the per-chip sequence count
    accum = per_chip_seqs // micro_seqs
    while per_chip_seqs % accum:
        accum += 1
    return accum


def _leaves(structs, specs) -> list:
    """[(Struct, spec)] of a tree of structs and the matching tree of specs."""
    if isinstance(structs, Struct):
        return [(structs, specs)]
    if isinstance(structs, dict):
        return [x for k in structs for x in _leaves(structs[k], specs[k])]
    return [x for a, b in zip(structs, specs) for x in _leaves(a, b)]


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each rank's block of a ``shape`` laid out by ``spec`` (every sharded
    dim divides: :func:`spec_for_input` drops the others)."""
    sizes = mesh_sizes(mesh)
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes.get(a, 1) for a in
                                ((p,) if isinstance(p, str) else (p or ())))
                 for d, p in zip(shape, parts))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    kind: str
    args_structs: Tuple
    in_shardings: Tuple
    mesh: Any
    rule_overrides: Optional[Dict[str, Any]] = None
    train_cfg: Optional[TrainConfig] = None
    capacity: int = 0
    window: int = 0

    def context(self, mesh=None) -> ShardingContext:
        return ShardingContext.for_arch(self.arch, mesh or self.mesh, self.rule_overrides)

    def materialize(self, device, mesh=None, generator: Optional[torch.Generator] = None):
        """(model, args) on ``device``: fake tensors inside a
        ``FakeTensorMode``, else real ones (random weights and inputs from
        ``generator``); each a DTensor laid out by its spec on a mesh of
        more than one dim name."""
        from repro_torch.distributed.zero import zero_shard_opt_state
        from repro_torch.train.trainer import trainable

        mesh = mesh or self.mesh
        ctx = self.context(mesh)
        fake = torch._guards.detect_fake_mode() is not None
        model = get_model(self.arch, device="meta" if fake else device)
        if fake:
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                mod = model.get_submodule(owner) if owner else model
                mod._parameters[leaf] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device), requires_grad=False)
        elif generator is not None:
            model.init(generator)

        def place(t, spec):
            return ctx.distribute_placements(t, spec_placements(spec, mesh))

        def tensor(struct, spec, name=""):
            kw = dict(dtype=struct.dtype, device=device)
            if fake or generator is None:
                t = torch.empty(struct.shape, **kw)
            elif struct.dtype == torch.int8:  # an int8 cache's codes
                t = torch.randint(-127, 128, struct.shape, generator=generator, **kw)
            elif not struct.dtype.is_floating_point:  # token ids; lens below the capacity
                hi = self.capacity - 1 if name in ("lens", "enc_lens") else self.arch.vocab_size
                t = torch.randint(0, hi, struct.shape, generator=generator, **kw)
            else:
                t = torch.randn(struct.shape, generator=generator, **kw)
            return place(t, spec)

        p_shards = self.in_shardings[0]
        with activate(ctx):
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                mod = model.get_submodule(owner) if owner else model
                mod._parameters[leaf] = torch.nn.Parameter(place(p.detach(), p_shards[name]),
                                                           requires_grad=False)
            params = dict(model.named_parameters())
            if self.kind == "train":
                params = trainable(model)
                opt_init, _ = OPTIMIZERS[self.train_cfg.optimizer]
                opt = zero_shard_opt_state(opt_init(params), model.param_logical_axes(), ctx,
                                           self.in_shardings[1])
                batch = {k: tensor(s, self.in_shardings[2][k], k)
                         for k, s in self.args_structs[2].items()}
                return model, (params, opt, batch, 0)
            if self.kind == "prefill":
                inputs = {k: tensor(s, self.in_shardings[1][k], k)
                          for k, s in self.args_structs[1].items()}
                return model, (params, inputs)
            tokens = tensor(self.args_structs[1], self.in_shardings[1], "tokens")
            cache = {k: tensor(s, self.in_shardings[2][k], k)
                     for k, s in self.args_structs[2].items()}
            return model, (params, tokens, cache)

    def step(self, model, *args):
        """One step of this cell's kind on ``model`` (built by
        :meth:`materialize`).  Decode takes no window argument: the one
        model with a window (zamba2) keeps its cache as a ring buffer of
        ``cache_capacity`` = the window's tokens, which bounds what it
        attends to."""
        if self.kind == "train":
            from repro_torch.train.trainer import make_train_step

            return make_train_step(model, self.train_cfg)(*args)
        if self.kind == "prefill":
            _, inputs = args
            extras = {k: v for k, v in inputs.items() if k != "tokens"}
            return model.prefill(inputs["tokens"], capacity=None, **extras)
        if self.window and self.window != self.capacity:
            raise NotImplementedError(f"a decode window of {self.window} over a cache of "
                                      f"{self.capacity} tokens")
        _, tokens, cache = args
        return model.decode(tokens, cache)

    def lower(self, mesh=None, device="cuda"):
        """Run one step on fake tensors under the cell's sharding context,
        inside an :class:`~repro_torch.roofline.opcount.OpCounter`; returns
        the counter, its ``output_bytes`` the live bytes the step's outputs
        hold at its end."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.roofline.opcount import OpCounter

        mesh = mesh or self.mesh
        with FakeTensorMode(allow_non_fake_inputs=True):
            model, args = self.materialize(device, mesh)
            with activate(self.context(mesh)):
                with OpCounter() as counter:
                    out = self.step(model, *args)
                    counter.output_bytes = counter.live  # what the step hands back
            del out
        return counter

    def resident_bytes_per_chip(self) -> int:
        """Exact per-chip bytes of all sharded inputs (params, optimizer
        state, batch, KV cache)."""
        total = 0
        for s, spec in _leaves(self.args_structs, self.in_shardings):
            n = math.prod(shard_shape(s.shape, spec, self.mesh))
            total += n * s.dtype.itemsize
        return total


# Train cells whose step is counted from four smaller traces: their plain
# chunked scans (no kernel: training has none) run a Python loop per chunk,
# ~270 ops a 16-token chunk, forward and backward, and a fake trace of every
# chunk of every micro-batch of every layer takes hours on one host core.
EXTRAPOLATED_FAMILIES = ("ssm", "hybrid")


@dataclass
class Counts:
    """An :class:`~repro_torch.roofline.opcount.OpCounter`'s read-outs,
    extrapolated (:func:`lower_extrapolated`)."""

    flops: float
    traffic: float
    collectives: Any
    peak: int
    output_bytes: int
    points: Tuple = ()

    def total_flops(self) -> float:
        return self.flops

    def total_traffic_bytes(self) -> float:
        return self.traffic

    def collective_stats(self):
        return self.collectives

    def peak_bytes(self) -> int:
        return self.peak


def _depth_unit(cfg: ArchConfig) -> Tuple[int, int]:
    """(layers per repeated unit, the layers after the last whole unit)."""
    if cfg.family == "hybrid":
        return cfg.shared_attn_every, cfg.num_layers % cfg.shared_attn_every
    return 1, 0


def lower_extrapolated(cell: "Cell", mesh=None, device="cuda") -> Counts:
    """A train cell's counts from four traces of its own widths, shapes and
    layout: 1 and 2 repeated layer units (plus the model's tail layers)
    times 2 and 3 micro-batches of the cell's micro-batch size (one
    micro-batch takes another path of the step: a cell of one takes only
    that count).  Every count is bilinear in (units, micro-batches): the
    units and the micro-batches repeat the same ops on the same shapes,
    around a fixed part (embedding, head, optimizer over the fixed leaves).
    Solved at the four points and read at the cell's own (units,
    ``grad_accum``): the port's counterpart of the reference's while-loop
    trip counts, which count a scan body once and multiply it by its
    trips.  The peak of live bytes is read the same way (an estimate)."""
    from repro_torch.roofline.opcount import CollectiveStats

    mesh = mesh or cell.mesh
    cfg, tc = cell.arch, cell.train_cfg
    unit, tail = _depth_unit(cfg)
    units = (cfg.num_layers - tail) // unit
    sizes = mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    micro = max(1, cell.shape.global_batch // dp) // tc.grad_accum
    # two micro-batch counts on the step's accumulating path (one micro-batch
    # takes another), or the cell's own single one
    accums = (2, 3) if tc.grad_accum > 1 else (1,)
    runs = {}
    for g in (1, 2):
        for a in accums:
            shape = ShapeConfig(cell.shape.name, cell.shape.seq_len, micro * a * dp, "train")
            small = build_cell(cfg.replace(num_layers=g * unit + tail), shape, mesh,
                               train_cfg=dataclasses.replace(tc, grad_accum=a),
                               rule_overrides=cell.rule_overrides)
            runs[g, a] = small.lower(mesh, device)

    def at(read) -> float:
        m = {k: read(c) for k, c in runs.items()}
        a1, a2 = accums[0], accums[-1]
        per_g = {a: m[2, a] - m[1, a] for a in accums}  # one more unit
        base = {a: m[1, a] - per_g[a] for a in accums}  # no unit
        if a1 == a2:
            return base[a1] + per_g[a1] * units
        A = tc.grad_accum

        def lerp(f):  # linear in the micro-batch count
            return f[a1] + (f[a2] - f[a1]) * (A - a1) / (a2 - a1)

        return lerp(base) + lerp(per_g) * units

    stats = CollectiveStats()
    ops = {op for c in runs.values() for op in c.collective_stats().count_by_op}
    for op in sorted(ops):
        wire, res, cnt = (lambda c, f=f: getattr(c.collective_stats(), f).get(op, 0)
                          for f in ("wire_bytes_by_op", "result_bytes_by_op", "count_by_op"))
        stats.wire_bytes_by_op[op] = at(wire)
        stats.result_bytes_by_op[op] = round(at(res))
        stats.count_by_op[op] = round(at(cnt))
    return Counts(at(lambda c: c.total_flops()), at(lambda c: c.total_traffic_bytes()), stats,
                  round(at(lambda c: c.peak_bytes())), round(at(lambda c: c.output_bytes)),
                  tuple((g * unit + tail, a) for g, a in runs))


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               train_cfg: Optional[TrainConfig] = None,
               rule_overrides: Optional[Dict[str, Any]] = None) -> Cell:
    model = get_model(cfg, device="meta")
    sizes = mesh_sizes(mesh)
    overrides = dict(rule_overrides or {})
    if (
        shape.kind == "train"
        and cfg.seq_parallel_train
        and cfg.family != "ssm"
        and "seq" not in overrides
        and shape.seq_len % sizes.get("model", 1) == 0
    ):
        # Megatron sequence parallelism: residual stream (and the remat'd
        # activation stacks) shard their seq dim over the model axis.
        overrides["seq"] = "model"
    ctx = ShardingContext.for_arch(cfg, mesh, overrides)

    p_structs, p_shards = param_structs(model, ctx)
    in_structs, in_shards = {}, {}
    for name, (shp, dt, ax) in model.input_specs(shape).items():
        in_structs[name], in_shards[name] = struct_and_sharding(ctx, shp, dt, ax)

    if shape.kind == "train":
        tc = train_cfg or TrainConfig(
            optimizer="adafactor" if cfg.opt_state_policy == "lite" else "adamw",
            grad_accum=default_grad_accum(cfg, shape, mesh),
        )
        o_structs, o_shards = opt_structs(model, ctx, tc)
        args = (p_structs, o_structs, in_structs, Struct((), torch.int32))
        in_sh = (p_shards, o_shards, in_shards, ())
        return Cell(cfg, shape, "train", args, in_sh, mesh, overrides, train_cfg=tc)

    if shape.kind == "prefill":
        return Cell(cfg, shape, "prefill", (p_structs, in_structs), (p_shards, in_shards),
                    mesh, overrides)

    # decode: one new token over a seq_len-deep cache
    capacity = cache_capacity(model, shape)
    window = decode_window(model, shape)
    c_structs, c_shards = {}, {}
    for name, (shp, dt, ax) in model.cache_shape(shape.global_batch, capacity).items():
        c_structs[name], c_shards[name] = struct_and_sharding(ctx, shp, dt, ax)
    args = (p_structs, in_structs["tokens"], c_structs)
    in_sh = (p_shards, in_shards["tokens"], c_shards)
    return Cell(cfg, shape, "decode", args, in_sh, mesh, overrides,
                capacity=capacity, window=window)
