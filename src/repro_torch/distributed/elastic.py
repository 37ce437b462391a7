"""Elastic scaling and fault handling for multi-device training, the port
of the JAX package's ``distributed/elastic.py``.

When a host (and its cards) drops out mid-run the job must (1) detect it,
(2) re-form a smaller mesh, (3) rebuild the step, (4) resume from the last
checkpoint.  This module holds the mesh side; the state side is
``checkpoint.CheckpointManager``.

Policy (MaxText-style): the ``model`` axis is sacred (weights are sharded
over it, so losing a card of a model group loses the whole replica), and
elasticity happens on the ``data`` axis in whole replicas: a 16 x 16 mesh
that loses a host re-forms as 15 x 16, and the batch re-shards over the
survivors.

The port is SPMD, one process per rank.  A :class:`Topology` is a grid of
global ranks ``[data, model]``; its mesh is a ``DeviceMesh`` over those
ranks.  Building a mesh creates its process groups, which every rank of the
world takes part in, the dropped ranks included; a rank outside the mesh
then leaves the step loop (:attr:`ElasticRunner.member` is False) instead
of entering a collective the survivors will not join.  Every collective
runs under its process group's timeout, so a lost rank fails a step
instead of hanging it.  ``ElasticRunner.on_failure`` drives the mechanics
in tests (real detection at scale comes from the launcher's heartbeats).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import ShardingContext, activate


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


@dataclass
class Topology:
    """The live grid of global ranks, ``[data, model]``."""

    ranks: np.ndarray  # int, shape [data, model]
    generation: int = 0
    _mesh: Optional[DeviceMesh] = field(default=None, repr=False, compare=False)

    @property
    def data(self) -> int:
        return self.ranks.shape[0]

    @property
    def model(self) -> int:
        return self.ranks.shape[1]

    def mesh(self) -> DeviceMesh:
        """The topology's mesh, built once (every rank of the world calls
        this: building it creates the mesh's process groups)."""
        if self._mesh is None:
            self._mesh = DeviceMesh(_device_type(), torch.as_tensor(self.ranks),
                                    mesh_dim_names=("data", "model"))
        return self._mesh

    def holds(self, rank: int) -> bool:
        return bool((self.ranks == rank).any())


def initial_topology(model_axis: int = 1) -> Topology:
    """Every rank of the world, ``model_axis`` to a data replica (a
    remainder that fills no replica is left out)."""
    n = dist.get_world_size()
    n = (n // model_axis) * model_axis
    return Topology(np.arange(n).reshape(-1, model_axis))


def drop_data_replica(topo: Topology, replica: int) -> Topology:
    """A host died: remove its whole data replica (the model axis is
    sacred)."""
    if topo.data <= 1:
        raise RuntimeError("cannot drop the last data replica")
    keep = [i for i in range(topo.data) if i != replica]
    return Topology(topo.ranks[np.asarray(keep)], topo.generation + 1)


def add_data_replica(topo: Topology, ranks: Sequence[int]) -> Topology:
    """Scale up: a new host joined with one replica's worth of ranks."""
    row = np.asarray(ranks).reshape(1, topo.model)
    return Topology(np.concatenate([topo.ranks, row], 0), topo.generation + 1)


class ElasticRunner:
    """Rebuilds the step whenever the topology changes.

    ``step_factory(cfg, mesh)`` returns the step (called inside the
    topology's sharding context); steps are cached per topology generation,
    and every rebuild is logged in ``relower_events`` with the reference's
    keys."""

    def __init__(self, cfg: ArchConfig, step_factory: Callable[[ArchConfig, DeviceMesh], Callable],
                 topo: Optional[Topology] = None, model_axis: int = 1):
        self.cfg = cfg
        self.step_factory = step_factory
        self.topo = topo or initial_topology(model_axis)
        self._cache: Dict[int, Callable] = {}
        self.relower_events: List[Dict[str, Any]] = []

    @property
    def mesh(self) -> DeviceMesh:
        return self.topo.mesh()

    @property
    def member(self) -> bool:
        """Whether this rank is in the live topology (a dropped rank leaves
        the step loop)."""
        return self.topo.holds(dist.get_rank())

    def context(self) -> ShardingContext:
        return ShardingContext.for_arch(self.cfg, self.mesh)

    def step_fn(self) -> Callable:
        gen = self.topo.generation
        if gen not in self._cache:
            t0 = time.perf_counter()
            mesh = self.mesh
            with activate(self.context()):
                self._cache[gen] = self.step_factory(self.cfg, mesh)
            self.relower_events.append({
                "generation": gen,
                "data": self.topo.data,
                "model": self.topo.model,
                "relower_s": round(time.perf_counter() - t0, 3),
            })
        return self._cache[gen]

    def run(self, *args, **kwargs):
        if not self.member:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the live topology")
        with activate(self.context()):
            return self.step_fn()(*args, **kwargs)

    # -- failure / scale events ------------------------------------------------
    def on_failure(self, replica: int) -> None:
        """Drop data replica ``replica`` and build the survivors' mesh (on
        every rank of the world)."""
        self.topo = drop_data_replica(self.topo, replica)
        self.topo.mesh()

    def on_join(self, ranks: Sequence[int]) -> None:
        self.topo = add_data_replica(self.topo, ranks)
        self.topo.mesh()


def reshard_batch(batch: Dict[str, Any], topo: Topology) -> Dict[str, Any]:
    """Trim the global batch (the same on every rank) to a multiple of the
    surviving replica count and shard it over ``data`` on the new mesh (the
    data pipeline is stateless per step, so shrinking is reslicing)."""
    mesh = topo.mesh()
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        b = (v.shape[0] // topo.data) * topo.data
        out[k] = distribute_tensor(v[:b].to(mesh.device_type), mesh, [Shard(0), Replicate()],
                                   src_data_rank=None)
    return out
