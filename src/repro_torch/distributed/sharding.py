"""Sharding, the port of the JAX package's ``distributed/sharding.py``: the
logical-axis rules of multi-device training on a torch ``DeviceMesh``, and
gather-TP, the serving engine's reduction-free tensor parallelism.

**Logical axes** (MaxText-style).  Models annotate tensors with *logical*
axis names ("batch", "heads", "d_ff", "vocab", "experts", "kv_blocks",
...).  A :class:`ShardingContext`, active inside a ``with activate(ctx):``
block, resolves them to mesh dims by its rules.  The reference is one
controller over many devices and constrains its arrays under GSPMD; the
port is SPMD, one process per rank (``torch.distributed.run``; ``nccl`` on
the card, ``gloo`` on the CPU), and its parameters and activations on a
mesh are DTensors: :func:`shard` redistributes a DTensor to the placements
its logical axes resolve to.  With no active context, or on a plain tensor,
every annotation is the identity, so the single-device path is unchanged
bit for bit.

A spec is a tuple with one entry per tensor dim: None, a mesh-dim name, or
a tuple of names (the entries of the reference's ``PartitionSpec``, with
its dedupe and tuple-preserving rules).  :meth:`ShardingContext.placements`
turns it into DTensor placements: a dim sharded over ``("pod", "data")``
takes ``Shard(d)`` on both mesh dims.  The rules and specs need only the
mesh's dim names and sizes, so they also take a :class:`StubMesh`.

Rules of thumb (the reference's):
  * ``batch`` always shards over ("pod", "data"): data parallelism.
  * Megatron TP over "model" for heads / d_ff / vocab / experts.
  * decode-KV layout is per arch: kv-heads sharded when they divide the
    model axis, otherwise (``kv_shard_mode="blocks"``) the KV sequence
    shards over "model" and decode attention runs split-K
    (``models.attention.decode_attention_blocksharded``).

**Gather-TP.**  The QKV projections and the MLP up-projections are
column-sharded across the shards; the output and down projections,
embeddings, norms and the unembedding are replicated.  Every cross-shard
combine is a concatenation (:func:`tp_allgather`) in shard order before a
replicated contraction, so the float summation order of every product is
the unsharded one and greedy decode is bitwise the same at any TP degree.
The reference runs one ``shard_map`` program per shard on a ``(1, tp)``
mesh; the port keeps its single controller: one process and one engine
thread hold the shards' column slices, each on its shard's device (a list
that may name one device more than once), launch each shard's work there,
and concatenate onto the primary device, where the replicated layers run
once.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import ArchConfig

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclass(frozen=True)
class StubMesh:
    """A mesh's dim names and sizes, with no devices and no process group:
    enough for :func:`default_rules` and :meth:`ShardingContext.spec`."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh-dim name: size} of a ``DeviceMesh`` or a :class:`StubMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def default_rules(cfg: ArchConfig, mesh) -> Dict[str, Axes]:
    """The reference's logical-axis rules for ``cfg`` on ``mesh``."""
    axis_names = tuple(mesh.mesh_dim_names)
    batch_axes: Axes = ("pod", "data") if "pod" in axis_names else ("data",)
    model_ax = mesh_sizes(mesh).get("model", 1)

    rules: Dict[str, Axes] = {
        "batch": batch_axes,
        "seq": None,
        "d_model": None,
        "heads": "model",
        "head_dim": None,
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": None,
        "state": None,
        "layers": None,
        "kv_heads": None,
        "kv_seq": None,
        "kv_blocks": None,
        "conv": None,
        "frames": None,
    }
    # decode-KV layout policy
    if cfg.kv_shard_mode == "heads" and cfg.num_kv_heads % model_ax == 0:
        rules["kv_heads"] = "model"
    elif cfg.kv_shard_mode == "blocks":
        rules["kv_seq"] = "model"
        rules["kv_blocks"] = "model"
    # heads fewer than the axis replicate (14 heads on 16); more heads than
    # the axis shard even when they do not divide it (40 on 16: GSPMD pads,
    # DTensor chunks unevenly)
    if cfg.num_heads < model_ax:
        rules["heads"] = None
    # RWKV / Mamba recurrent heads shard over model when they divide evenly
    if cfg.ssm is not None and cfg.num_heads % model_ax == 0:
        rules["heads"] = "model"
    return rules


class Sharding(NamedTuple):
    """A mesh and the placements of one tensor on it (the reference's
    ``NamedSharding``)."""

    mesh: object
    placements: Tuple[object, ...]


def spec_placements(spec: Spec, mesh) -> Tuple[object, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim of more than one rank that tensor dim ``d`` names,
    ``Replicate()`` on the others (a dim of one rank holds the whole
    tensor either way, and DTensor reshapes a replicated dim more freely)."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: List[object] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass
class ShardingContext:
    mesh: object  # a DeviceMesh, or a StubMesh for the rules alone
    rules: Dict[str, Axes]
    cfg: Optional[ArchConfig] = None

    @classmethod
    def for_arch(cls, cfg: ArchConfig, mesh,
                 overrides: Optional[Dict[str, Axes]] = None) -> "ShardingContext":
        rules = default_rules(cfg, mesh)
        rules.update(dict(cfg.sharding_overrides))
        if overrides:
            rules.update(overrides)
        return cls(mesh=mesh, rules=rules, cfg=cfg)

    def spec(self, logical: Sequence[Optional[str]]) -> Spec:
        names = tuple(self.mesh.mesh_dim_names)
        parts: List[Axes] = []
        used: set = set()
        for name in logical:
            ax = self.rules.get(name) if name else None
            if ax is None:
                parts.append(None)
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a in names and a not in used)
            used.update(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1 and isinstance(ax, str):
                parts.append(axes[0])
            else:
                # rules declared as tuples (batch over ("pod", "data")) stay
                # tuples even when filtering leaves a single axis
                parts.append(axes)
        return tuple(parts)

    def placements(self, logical: Sequence[Optional[str]]) -> Tuple[object, ...]:
        return spec_placements(self.spec(logical), self.mesh)

    def sharding(self, logical: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.placements(logical))

    @property
    def distributed(self) -> bool:
        """True on a real ``DeviceMesh`` (False on a :class:`StubMesh`)."""
        return not isinstance(self.mesh, StubMesh)

    def distribute(self, t: torch.Tensor, logical: Sequence[Optional[str]]) -> DTensor:
        """``t``, the same full tensor on every rank, as a DTensor with the
        placements of ``logical``: each rank keeps its own chunk, with no
        communication."""
        return self.distribute_placements(t, self.placements(logical))

    def distribute_placements(self, t: torch.Tensor, placements) -> DTensor:
        return distribute_tensor(t, self.mesh, placements, src_data_rank=None)


# The active context is process-wide, where the reference's is thread-local:
# the autograd engine runs a CUDA backward pass, and with it the recomputation
# of checkpointed blocks (and their ``shard()`` points), on threads of its own.
_active: List[Optional[ShardingContext]] = [None]
_state = threading.local()  # the TP body's axis, per thread


def current_context() -> Optional[ShardingContext]:
    return _active[0]


@contextlib.contextmanager
def activate(ctx: Optional[ShardingContext]):
    """Make ``ctx`` the current context (for the process).  On a real mesh,
    plain tensors that meet DTensors inside the block (positions, masks,
    the optimizer's scalars) count as replicated."""
    prev = current_context()
    _active[0] = ctx
    try:
        # implicit_replication's exit switches it off: only the outermost
        # context on a mesh enters it
        if ctx is not None and ctx.distributed and not (prev is not None and prev.distributed):
            with implicit_replication():
                yield ctx
        else:
            yield ctx
    finally:
        _active[0] = prev


def shard(x, *logical: Optional[str]):
    """Redistribute the DTensor ``x`` to the placements of ``logical``; the
    identity without an active context, inside a TP body, or on a plain
    tensor."""
    ctx = current_context()
    if ctx is None or tp_axis() is not None or not isinstance(x, DTensor):
        return x
    pl = ctx.placements(logical)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor on every rank (a collective for a DTensor: every
    rank calls it); ``x`` itself when plain."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _batch_dims(ctx: ShardingContext) -> Tuple[str, ...]:
    ax = ctx.rules.get("batch")
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def local(x, *logical: Optional[str]) -> torch.Tensor:
    """This rank's block of ``x`` laid out as ``logical`` (as it is laid out
    when no axes are given), for the ops that
    DTensor has no sharding strategy for (data-dependent gathers and
    scatters), which then run on local tensors, each rank on its own batch
    block: the gradient of the result is taken as partial over the batch
    mesh dims along which ``x`` is replicated (a replicated weight used per
    batch block).  ``x`` itself when plain."""
    if not isinstance(x, DTensor):
        return x
    ctx = current_context()
    if logical:
        x = shard(x, *logical)
    batch = _batch_dims(ctx)
    grad = [Partial() if n in batch and isinstance(pl, Replicate) else pl
            for n, pl in zip(x.device_mesh.mesh_dim_names, x.placements)]
    return x.to_local(grad_placements=grad)


def on_blocks(fn, args: Sequence[torch.Tensor], in_axes: Sequence[Sequence[Optional[str]]],
              out_axes: Sequence[Sequence[Optional[str]]]):
    """``fn`` over this rank's blocks, for a computation that is independent
    per batch row and per head (a kernel, a scan).  When an argument is a
    DTensor under an active context on a mesh, every argument is laid out
    as its ``in_axes`` and passed as its local block, contiguous (a plain
    one, the same full tensor on every rank, is distributed without
    communication; a DTensor as its block, its gradient a partial sum along
    the mesh dims over which it is replicated and the work is split);
    ``fn``'s outputs (a tensor or a tuple) come back through
    :func:`from_local`, laid out as ``out_axes``.  Otherwise ``fn(*args)``."""
    ctx = current_context()
    if ctx is None or not ctx.distributed or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    # a logical axis that some argument's dim does not divide (one batch row
    # over many data ranks) stays whole: a block of every rank is then the
    # same size, which DTensor.from_local assumes
    sizes = mesh_sizes(ctx.mesh)
    names = set(ctx.mesh.mesh_dim_names)

    def shards(name) -> int:
        ax = ctx.rules.get(name)
        return math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str) else ax or ())
                         if a in names)

    uneven = {n for a, ax in zip(args, in_axes) for d, n in zip(a.shape, ax)
              if n is not None and d % shards(n)}
    in_axes, out_axes = ([tuple(None if n in uneven else n for n in ax) for ax in axes]
                         for axes in (in_axes, out_axes))
    # each rank works on its own block along the mesh dims that split an
    # output; an argument replicated along such a dim (Mamba2's B and C,
    # shared by the heads) gets its gradient there as a partial sum
    split = {i for ax in out_axes for i, p in enumerate(ctx.placements(ax)) if p.is_shard()}

    def block(a, ax):
        if not isinstance(a, DTensor):
            return ctx.distribute(a, ax).to_local()
        a = shard(a, *ax)
        return a.to_local(grad_placements=[Partial() if i in split and p.is_replicate() else p
                                           for i, p in enumerate(a.placements)])

    blocks = [block(a, ax).contiguous() for a, ax in zip(args, in_axes)]
    out = fn(*blocks)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(from_local(o, *ax) for o, ax in zip(outs, out_axes))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def reduce_partials(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tree`` with every DTensor leaf that holds a partial sum reduced
    (``Replicate`` on those mesh dims); plain leaves as they are.  A decode
    writes into its cache in place, and DTensor writes the new value into
    every rank's term of a partial sum, which then counts it once per rank:
    a prefill's cache may come back partial (a row-parallel product's
    output), so a decode reduces it first."""
    out = {}
    for k, t in tree.items():
        if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
            t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                               for p in t.placements])
        out[k] = t
    return out


def batch_sum(t: torch.Tensor):
    """``t``, a sum over this rank's batch block, as the sum over the
    global batch (a replicated DTensor; differentiable).  ``t`` itself
    without an active context on a real mesh."""
    ctx = current_context()
    if ctx is None or not ctx.distributed:
        return t
    batch = _batch_dims(ctx)
    names = ctx.mesh.mesh_dim_names
    part = DTensor.from_local(t, ctx.mesh, [Partial() if n in batch else Replicate()
                                            for n in names], run_check=False)
    return part.redistribute(ctx.mesh, [Replicate()] * len(names))


def from_local(t: torch.Tensor, *logical: Optional[str]):
    """The inverse of :func:`local`: ``t``, this rank's block, as a DTensor
    laid out as ``logical`` (differentiable).  ``t`` itself without an
    active context on a real mesh."""
    ctx = current_context()
    if ctx is None or not ctx.distributed:
        return t
    return DTensor.from_local(t, ctx.mesh, ctx.placements(logical), run_check=False)


def distribute_params(model: torch.nn.Module, ctx: ShardingContext) -> torch.nn.Module:
    """Make each parameter of ``model`` (the same full weights on every
    rank) a DTensor laid out as its ``model.param_logical_axes()``, in
    place, with no communication; a parameter keeps its ``requires_grad``.
    Returns ``model``."""
    axes = model.param_logical_axes()
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        data = p.full_tensor() if isinstance(p, DTensor) else p.detach()
        mod._parameters[leaf] = torch.nn.Parameter(ctx.distribute(data, axes[name]),
                                                   requires_grad=p.requires_grad)
    return model


def logical_spec(*logical: Optional[str]) -> Spec:
    ctx = current_context()
    if ctx is None:
        return ()
    return ctx.spec(logical)


def sharding_for(*logical: Optional[str]) -> Optional[Sharding]:
    ctx = current_context()
    if ctx is None:
        return None
    return ctx.sharding(logical)


def model_axis_size() -> int:
    ctx = current_context()
    if ctx is None:
        return 1
    return mesh_sizes(ctx.mesh).get("model", 1)


def mesh_axis_names() -> Tuple[str, ...]:
    ctx = current_context()
    if ctx is None:
        return ()
    return tuple(ctx.mesh.mesh_dim_names)


def tp_axis() -> Optional[str]:
    """The mesh axis of an enclosing per-shard TP program, or None: inside
    one every tensor is already the local shard and :func:`shard` is the
    identity."""
    return getattr(_state, "tp_axis", None)


@contextlib.contextmanager
def tp_body(axis: str = "model"):
    prev = tp_axis()
    _state.tp_axis = axis
    try:
        yield
    finally:
        _state.tp_axis = prev


# ---------------------------------------------------------------------------
# Gather-TP (reduction-free tensor parallelism of the serving engine)
# ---------------------------------------------------------------------------

# the column-sharded leaves among the port's parameter names:
# ``layers.{i}.attn.wq`` [d, H, hd], ``wk``/``wv`` [d, KV, hd] along their
# head axis, and ``layers.{i}.mlp.w_gate``/``w_up`` [d, f] along d_ff
_COLUMN_SHARDED = re.compile(r"(^|\.)(attn\.w[qkv]|mlp\.w_(gate|up))$")


def gather_tp_spec(name: str) -> Optional[int]:
    """The axis along which gather-TP shards the port's parameter ``name``
    (1 for the QKV heads and the MLP's d_ff), or None when it is
    replicated."""
    return 1 if _COLUMN_SHARDED.search(name) else None


def tp_allgather(parts: Sequence[torch.Tensor], axis: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Concatenate the shards' partials along ``axis`` on ``device`` (the
    reference's tiled ``all_gather``): a pure concatenation in shard order.
    The identity for one shard."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=axis)


def check_tp(cfg: ArchConfig, tp: int) -> None:
    """Refuse what the reference's tensor-parallel serving refuses, with its
    messages: any family but the dense one (NotImplementedError), and a
    ``tp`` that does not divide the heads, the KV heads and d_ff
    (ValueError)."""
    if tp <= 1:
        return
    if cfg.moe is not None or cfg.modality is not None:
        raise NotImplementedError("tensor-parallel serving covers the dense family only")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}, "
                         f"num_kv_heads={cfg.num_kv_heads} and d_ff={cfg.d_ff}")
