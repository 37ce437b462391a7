"""Shared pytest fixtures of the port's tests.

``one_thread`` pins torch's intra-op pool to one thread for a whole test
module and restores the count afterwards.  The suite runs several pytest
workers on the CPU's cores at once; each worker with torch's default pool
(one thread per core) oversubscribes the cores several times over and slows
every worker.  A test file takes it with::

    from repro_torch.testing import one_thread  # noqa: F401

An imported autouse fixture registers in the importing module.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gloo_entry(rank: int, world: int, port: int, timeout_s: float, fn, args) -> None:
    import os
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, world: int, *args, timeout_s: float = 60.0):
    """Start ``world`` processes, each with a ``gloo`` group on 127.0.0.1
    (a free port; every collective under ``timeout_s``), one torch thread
    and the launcher's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, running
    ``fn(rank, *args)`` (a module-level function).  Returns the
    ``torch.multiprocessing`` context unjoined: ``.join()`` it (it raises
    when a rank failed)."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    return mp.spawn(_gloo_entry, args=(world, free_port(), timeout_s, fn, args),
                    nprocs=world, join=False)
