"""Gradient-compression collectives, the port of the JAX package's
``distributed/collectives.py``.

* :func:`int8_allreduce_mean` — the gradient-compression all-reduce over
  the data axes of a ``DeviceMesh``: a shared max-abs scale (an all-reduce
  MAX), int8 codes, an int32 all-reduce SUM, dequantised.  The quantised
  payload is what crosses the interconnect, and the int32 sum is exact, so
  every rank gets the same, deterministic, result.
* :func:`int8_roundtrip` — quantise then dequantise each leaf with a
  per-tensor max-abs scale: the error model of the int8 all-reduce, which
  the trainer applies to its gradients (on a mesh as on one device, as the
  reference's GSPMD-partitioned step does).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 g -> (int8 codes ``round(g / scale)`` clipped to ±127, round
    half to even as ``jnp.round``; scale ``max|g| / 127 + 1e-12``)."""
    scale = g.abs().max() / 127.0 + 1e-12
    return torch.round(g / scale).clamp(-127, 127).to(torch.int8), scale


@torch.no_grad()
def int8_roundtrip(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Quantise-dequantise each leaf, back in its own dtype."""
    out = {}
    for k, g in tree.items():
        q, scale = _quantise(g.float())
        out[k] = (q.float() * scale).to(g.dtype)
    return out


@torch.no_grad()
def int8_allreduce_mean(tree: Mapping[str, torch.Tensor], mesh,
                        data_axes: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """Mean-all-reduce each leaf of ``tree`` over the mesh dims
    ``data_axes`` with an int8 payload: every rank passes its own leaves
    (plain tensors, or DTensors whose local blocks are reduced), which are
    replicated over the mesh's other dims.  Each leaf: the max of the
    ranks' max-abs (all-reduce MAX), the shared scale ``max / 127 + 1e-12``,
    codes ``round(g / scale)`` clipped to ±127, their int32 all-reduce SUM,
    times ``scale / n``; back in the leaf's dtype.  Over several axes the
    reductions run one mesh dim after the other (a max and an integer sum
    are exact in any order)."""
    axes = tuple(a for a in data_axes if a in mesh.mesh_dim_names)
    if not axes:
        return dict(tree)
    groups = [mesh.get_group(a) for a in axes]
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    out = {}
    for k, g in tree.items():
        gl = g.to_local() if isinstance(g, DTensor) else g
        g32 = gl.float()
        scale = g32.abs().max()
        for grp in groups:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=grp)
        scale = scale / 127.0 + 1e-12
        s = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8).to(torch.int32)
        for grp in groups:
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=grp)
        r = (s.float() * scale / n).to(gl.dtype)
        out[k] = DTensor.from_local(r, g.device_mesh, g.placements, run_check=False) \
            if isinstance(g, DTensor) else r
    return out
