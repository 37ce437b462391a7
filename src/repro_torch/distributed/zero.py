"""ZeRO-style optimizer-state sharding, the port of the JAX package's
``distributed/zero.py``.

Optimizer moments follow their parameter's sharding and additionally shard
their largest still-unsharded dim over the ``data`` axis when it divides
evenly: optimizer state partitioned across the data-parallel replicas
(ZeRO-1/2), parameters laid out as model parallelism has them.

The reference decides on its own leaves, which stack a per-layer parameter
over its layers (``[L, ...]``); the port's leaves are per layer.  So the
port decides on the reference's stacked shape (``models.bridge.
reference_leaves``) and keeps the reference's choice for the dims it has:
its moments shard the dim the reference's do.  Where the reference's
choice is the stacked layer dim itself, the port's per-layer moment has no
such dim and stays replicated over ``data``.  A factored Adafactor moment
(``{"row", "col"}``) takes the replicated spec as its parameter spec, as in
the reference, before the ZeRO extension.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import ShardingContext, Spec, mesh_sizes, spec_placements
from repro_torch.models.bridge import reference_leaves


def zero_spec_for(param_spec: Spec, shape: Sequence[int], mesh, axis: str = "data") -> Spec:
    """Extend ``param_spec`` by sharding the largest free dim of ``shape``
    that ``axis`` divides over ``axis`` (the first such dim on a tie)."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        return tuple(param_spec)
    size = mesh_sizes(mesh)[axis]
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for p in parts:
        if p is not None:
            used.update(p if isinstance(p, tuple) else (p,))
    if axis in used:
        return tuple(param_spec)
    best, best_dim = -1, -1
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % size == 0 and d > best:
            best, best_dim = d, i
    if best_dim < 0:
        return tuple(param_spec)
    parts[best_dim] = axis
    return tuple(parts)


def zero_specs(opt_state: Mapping[str, Any], param_axes: Mapping[str, Tuple],
               ctx: ShardingContext, cfg=None) -> Dict[str, Any]:
    """The ZeRO spec of every leaf of ``opt_state`` (``{"m", "v"}``, each
    {parameter name: tensor, or {"row", "col"}}) in the same structure.
    ``param_axes`` is the model's ``param_logical_axes()``; ``cfg`` (the
    arch, default ``ctx.cfg``) gives the reference's stacking."""
    cfg = cfg or ctx.cfg
    lead = {}
    for _, shape, group in reference_leaves(param_axes.keys(), cfg):
        for n in group:
            lead[n] = tuple(shape)

    def one(name, leaf, factored):
        L = lead.get(name, ())
        axes = param_axes[name]
        spec = ctx.spec(axes) if not factored and len(axes) == leaf.ndim else (None,) * leaf.ndim
        stacked = zero_spec_for((None,) * len(L) + tuple(spec), L + tuple(leaf.shape), ctx.mesh)
        return stacked[len(L):]

    out = {}
    for part, tree in opt_state.items():
        out[part] = {k: ({s: one(k, t, True) for s, t in v.items()} if isinstance(v, Mapping)
                         else one(k, v, False)) for k, v in tree.items()}
    return out


def _place(leaf: torch.Tensor, spec: Spec, ctx: ShardingContext) -> DTensor:
    pl = spec_placements(spec, ctx.mesh)
    if isinstance(leaf, DTensor):
        return leaf if tuple(leaf.placements) == pl else leaf.redistribute(ctx.mesh, pl)
    return distribute_tensor(leaf, ctx.mesh, pl, src_data_rank=None)


def zero_shard_opt_state(opt_state: Mapping[str, Any], param_axes: Mapping[str, Tuple],
                         ctx: ShardingContext, specs: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Lay every leaf of ``opt_state`` out by its ZeRO spec
    (:func:`zero_specs`, or the ``specs`` already computed): a DTensor is
    redistributed, a plain tensor (the same full tensor on every rank, as
    an optimizer's init gives) distributed without communication."""
    specs = specs or zero_specs(opt_state, param_axes, ctx)
    out = {}
    for part, tree in opt_state.items():
        out[part] = {k: ({s: _place(t, specs[part][k][s], ctx) for s, t in v.items()}
                         if isinstance(v, Mapping) else _place(v, specs[part][k], ctx))
                     for k, v in tree.items()}
    return out
