"""The devices the shards of a tensor-parallel engine sit on: the port's
counterpart of the JAX package's ``launch/mesh.py``, whose engine builds a
``(1, tp)`` mesh over the first ``tp`` devices."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

Device = Union[str, torch.device]


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
