"""Meshes and shard devices, the port's counterpart of the JAX package's
``launch/mesh.py``.

* :func:`start_world` — the process group of the launcher's world
  (``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK``): ``nccl`` with one card per local rank, or ``gloo`` on the
  CPU, every collective under ``COLLECTIVE_TIMEOUT_S``.
* :func:`make_local_mesh` / :func:`make_mesh` — a ``DeviceMesh`` over that
  world, for multi-device training.  Functions, not
  module constants: importing this module touches no device or group.
* :func:`make_production_mesh` — the dry run's 16 x 16 (``data``,
  ``model``) or 2 x 16 x 16 (``pod``, ``data``, ``model``) mesh over a fake
  world of 256 or 512 ranks (the ``fake`` backend: no communication, this
  process rank 0), the reference's mesh shapes, so that every per-chip
  count can be held to the reference's.  On H100 hosts of 8 NVLink-joined
  cards, a 16-wide model axis spans two NVLink domains.
* :func:`shard_devices` — the devices the shards of a tensor-parallel
  engine sit on (the reference's engine builds a ``(1, tp)`` mesh over the
  first ``tp`` devices).
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.config import MeshConfig

Device = Union[str, torch.device]

COLLECTIVE_TIMEOUT_S = 300.0  # a collective of the launcher's world fails after it


def shard_devices(tp: int, device: torch.device,
                  devices: Optional[Sequence[Device]] = None) -> List[torch.device]:
    """One device per shard for an engine on ``device``.

    An explicit ``devices`` list is taken as given, repeated devices
    included (every shard on one card; the reference's fake host devices).
    Otherwise a CPU engine puts every shard on the CPU, and a CUDA engine
    takes ``cuda:0`` .. ``cuda:tp-1`` and raises ValueError, as the
    reference does, when ``tp`` exceeds the cards there are: nothing falls
    back to the CPU or to fewer shards."""
    tp = max(1, int(tp))
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != tp:
            raise ValueError(f"tp={tp} needs {tp} shard devices, got {len(devs)}")
        return devs
    if device.type == "cpu":
        return [device] * tp
    if tp == 1:
        return [device]
    n = torch.cuda.device_count()
    if tp > n:
        raise ValueError(f"tp={tp} exceeds the {n} available device(s); pass "
                         "shard_devices (one device may repeat) or lower --tp")
    return [torch.device("cuda", i) for i in range(tp)]


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(cfg: MeshConfig) -> DeviceMesh:
    """A mesh of ``cfg``'s shape and dim names over the started world,
    whose size must be ``cfg.num_devices``."""
    n = _world()
    if n != cfg.num_devices:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} ranks, the world has {n}")
    return init_device_mesh(_mesh_device_type(), cfg.shape, mesh_dim_names=cfg.axis_names)


def make_local_mesh(model: Optional[int] = None) -> DeviceMesh:
    """A ``(world // model, model)`` data x model mesh over the started
    world (tests and smoke runs).

    Raises ``ValueError`` (not an assert: those vanish under ``python -O``)
    when the model axis exceeds, or does not divide, the world."""
    n = _world()
    model = model or 1
    if model > n:
        raise ValueError(
            f"model axis {model} exceeds the {n} available device(s); start more "
            f"ranks (python -m torch.distributed.run --nproc-per-node N) or lower --tp")
    if n % model != 0:
        raise ValueError(f"model axis {model} does not divide the {n} available device(s)")
    return make_mesh(MeshConfig(data=n // model, model=model))


def start_fake_world(world: int) -> None:
    """Make the default process group a ``fake`` one of ``world`` ranks,
    this process rank 0 (a running fake group of another size is replaced;
    a real group is never touched: ValueError)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(f"a {dist.get_backend()} process group is running; destroy it "
                             "before building the production mesh")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks), over a
    fake world (:func:`start_fake_world`) for tracing one rank's step."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    start_fake_world(math.prod(shape))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launched_world() -> int:
    """The world size ``torch.distributed.run`` set (1 without a launcher)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def start_world(device: torch.device) -> Tuple[torch.device, bool]:
    """Start the launcher's process group unless one is running: ``nccl`` on
    card ``LOCAL_RANK`` for a CUDA ``device`` (made current), ``gloo`` for
    the CPU.  Returns (this rank's device, whether this call started the
    group: then the caller destroys it)."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                            device_id=device if device.type == "cuda" else None)
    return device, True
