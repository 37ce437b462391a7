"""Paged dual-pool KV cache: device (HBM) pool + host (DRAM) pool.

Layout per pool: K and V tensors of shape ``[L, P, page, KV, hd]`` —
page-major so a page is one contiguous copy unit (the swap granularity).
The device pool is one CUDA tensor in the activation dtype, updated in place
(the JAX package rebuilds it functionally with ``.at[].set``).  The host
pool is a CPU tensor — pinned when the device is CUDA, so page copies to and
from the card are DMA-able — whose ``.numpy()`` view is shared with
:class:`~repro_torch.core.host_attention.HostAttention` without a copy.  Its
dtype is float16 for 16-bit archs and float32 otherwise, as the reference's
numpy host pool (numpy has no bfloat16), so sizing and swap-byte accounting
see the same byte counts on both sides.

Free-page accounting is host-side Python, exactly like vLLM's block manager
and the reference: free list, per-page refcounts, an optional refcount
listener.

Two sets of page I/O: the blocking whole-request copy of the serial path
(:meth:`PagePool.read_pages` / :meth:`PagePool.put_pages`,
:meth:`DualPool.swap_request`; the prefix cache's page copies use the same
pair), and the primitives of the asynchronous
transfers of :mod:`repro_torch.core.transfer` — :meth:`PagePool.gather`
(whole pages, all layers, into a staging tensor on the pool's device, cast
there), :meth:`PagePool.scatter` (a staging tensor back into pages) and
:func:`copy_async` (staging to the other side of PCIe on a given stream,
into pinned memory when it lands on the host, with an event recorded after
the copy).

Tensor parallelism (gather-TP) shards the device pool by KV head: one
``[L, P, page, KV/tp, hd]`` k/v pair per shard device (``shard_k`` /
``shard_v``; ``k``/``v`` are the one pair of an unsharded pool, None
otherwise).  The page-id space — free list, refcounts, ``Request.pages`` and
the prefix cache's tree — stays global: every shard holds every page, each
over its own KV heads.  The host pool stays one allocation, and
:meth:`PagePool.kv_head_slice` gives each shard's host attention writable
numpy views of its KV heads.  The transfer primitives (``gather``,
``scatter``) and ``read_pages`` / ``put_pages`` take ``shard=(s, n)`` for the
``s``-th of ``n`` KV-head parts (a sharded device pool's shard ``s``, or a
view of an unsharded pool's heads); without it ``read_pages``,
``put_pages`` and ``write_token_range`` read or write every shard,
concatenating or splitting on the KV axis.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device, torch_dtype


class PagePool:
    """One pool (device or host) with a free list."""

    def __init__(
        self,
        cfg: ArchConfig,
        num_pages: int,
        *,
        backend: str,  # "device" | "host"
        device: torch.device,
        num_layers: Optional[int] = None,
        shard_devices: Optional[Sequence[torch.device]] = None,
    ):
        self.cfg = cfg
        self.backend = backend
        self.page_size = cfg.kv_block_size
        self.num_pages = num_pages
        L = num_layers if num_layers is not None else cfg.num_attention_layers
        self.num_layers = L
        KV = cfg.num_kv_heads
        if backend == "device":
            self.devices = [torch.device(d) for d in shard_devices or [device]]
            n = len(self.devices)
            if KV % n:
                raise ValueError(f"{KV} kv heads do not divide across {n} shards")
            shape = (L, num_pages, self.page_size, KV // n, cfg.head_dim)
            self.dtype = torch_dtype(cfg.activation_dtype)
            self.shard_k = [torch.zeros(shape, dtype=self.dtype, device=d) for d in self.devices]
            self.shard_v = [torch.zeros(shape, dtype=self.dtype, device=d) for d in self.devices]
        elif backend == "host":
            shape = (L, num_pages, self.page_size, KV, cfg.head_dim)
            self.devices = [torch.device("cpu")]
            self.dtype = torch.float32 if cfg.activation_dtype == "float32" else torch.float16
            pin = device.type == "cuda"
            self.shard_k = [torch.zeros(shape, dtype=self.dtype, pin_memory=pin)]
            self.shard_v = [torch.zeros(shape, dtype=self.dtype, pin_memory=pin)]
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.num_shards = len(self.shard_k)
        unsharded = self.num_shards == 1
        self.k: Optional[torch.Tensor] = self.shard_k[0] if unsharded else None
        self.v: Optional[torch.Tensor] = self.shard_v[0] if unsharded else None
        self.pinned = self.shard_k[0].is_pinned()  # a host pool beside a card
        self._free: List[int] = list(range(num_pages))
        # Per-page reference counts: a page returns to the free list only
        # when its LAST reader releases it.
        self._ref: List[int] = [0] * num_pages
        # Optional refcount-transition listener ``fn(page, old, new)``.
        self._ref_listener: Optional[Callable[[int, int, int], None]] = None

    def set_ref_listener(self, fn: Optional[Callable[[int, int, int], None]]) -> None:
        self._ref_listener = fn

    # -- accounting ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"{self.backend} pool out of pages: want {n}, have {len(self._free)}"
            )
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages: List[int]) -> None:
        """Add a reader to already-allocated (shared) pages."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"incref of free page {p}")
            self._ref[p] += 1
            if self._ref_listener is not None:
                self._ref_listener(p, self._ref[p] - 1, self._ref[p])

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def free(self, pages: List[int]) -> None:
        """Release one reference per page; pages with no remaining readers
        return to the free list (a double release raises)."""
        if len(set(pages)) != len(pages):
            raise ValueError("duplicate pages in free()")
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range [0, {self.num_pages})")
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
            if self._ref_listener is not None:
                self._ref_listener(p, self._ref[p] + 1, self._ref[p])

    # -- KV-head parts (tensor parallelism) ------------------------------------
    def _part(self, shard: Optional[Tuple[int, int]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The k/v tensors of KV-head part ``shard = (s, n)``: a sharded
        pool's shard ``s`` (``n`` must be its shard count), or a view of an
        unsharded pool's heads; the whole pool for None."""
        if shard is None:
            if self.num_shards > 1:
                raise ValueError("a sharded pool is read and written per shard")
            return self.k, self.v
        s, n = shard
        if n == self.num_shards:
            return self.shard_k[s], self.shard_v[s]
        if self.num_shards > 1:
            raise ValueError(f"part {s} of {n} of a pool sharded {self.num_shards} ways")
        KV = self.k.shape[3]
        if KV % n:
            raise ValueError(f"{KV} kv heads do not divide across {n} shards")
        lo, hi = s * KV // n, (s + 1) * KV // n
        return self.k[:, :, :, lo:hi], self.v[:, :, :, lo:hi]

    def part_device(self, shard: Optional[Tuple[int, int]]) -> torch.device:
        return self._part(shard)[0].device

    def _whole(self, shard) -> bool:
        """Whether a call without a part spans a sharded pool's shards."""
        return shard is None and self.num_shards > 1

    def _parts(self) -> List[Tuple[int, int]]:
        return [(s, self.num_shards) for s in range(self.num_shards)]

    def kv_head_slice(self, shard: int, num_shards: int) -> Tuple[np.ndarray, np.ndarray]:
        """Writable numpy VIEWS of this host pool over shard ``shard``'s KV
        heads, [L, P, page, KV/num_shards, hd] (strided): each shard's host
        attention reads and appends through them, so the host tier stays ONE
        allocation with one global page-id space."""
        if self.backend != "host":
            raise ValueError("kv_head_slice is a host-pool view")
        k, v = self._part((shard, num_shards))
        return k.numpy(), v.numpy()

    # -- page I/O ----------------------------------------------------------------
    def read_pages(self, pages, shard: Optional[Tuple[int, int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of ``pages`` (a list, or page ids of any shape) across all
        layers, [L, *shape, page, KV, hd], on this pool's device and in its
        dtype (KV/n of part ``shard``, on its device; a sharded pool's
        shards concatenated on the first one's device)."""
        if self._whole(shard):
            parts = [self.read_pages(pages, p) for p in self._parts()]
            dev = self.devices[0]
            return tuple(torch.cat([p[i].to(dev) for p in parts], dim=-2) for i in (0, 1))
        k, v = self._part(shard)
        idx = torch.as_tensor(pages, dtype=torch.long, device=k.device)
        return k[:, idx], v[:, idx]

    def put_pages(self, pages: List[int], k: torch.Tensor, v: torch.Tensor,
                  shard: Optional[Tuple[int, int]] = None) -> None:
        """Write [L, n, page, KV, hd] into ``pages``, cast to this pool's
        dtype and moved to its device.  Casts run on the card (before a
        device→host copy, after a host→device one), so only the host pool's
        byte width crosses PCIe.  A sharded pool takes each shard's KV
        heads (or part ``shard``'s alone)."""
        if self._whole(shard):
            n = self.num_shards
            for p, ks, vs in zip(self._parts(), k.chunk(n, dim=3), v.chunk(n, dim=3)):
                self.put_pages(pages, ks, vs, p)
            return
        kt, vt = self._part(shard)
        dev = kt.device
        idx = torch.as_tensor(pages, dtype=torch.long, device=dev)
        if self.backend == "device":
            k, v = k.to(dev).to(self.dtype), v.to(dev).to(self.dtype)
        else:
            k, v = k.to(self.dtype).to(dev), v.to(self.dtype).to(dev)
        kt[:, idx] = k
        vt[:, idx] = v

    def gather(self, pages: Sequence[int], dtype: Optional[torch.dtype] = None,
               shard: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of whole ``pages`` (every layer), [L, n, page, KV, hd], on
        this pool's device in ``dtype`` (this pool's by default), enqueued on
        the current stream: a snapshot that later writes to the pages do not
        change once the stream has run it.  A pinned pool gathers into pinned
        memory, so a copy to the card reads the snapshot as it is.  With
        ``shard``, part ``shard``'s KV heads alone."""
        kt, vt = self._part(shard)
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=kt.device)
        dtype = dtype or self.dtype

        def select(t: torch.Tensor) -> torch.Tensor:
            if not self.pinned:
                return t.index_select(1, idx)
            out = torch.empty((t.shape[0], len(idx), *t.shape[2:]), dtype=t.dtype,
                              pin_memory=True)
            return torch.index_select(t, 1, idx, out=out)

        return select(kt).to(dtype), select(vt).to(dtype)

    def scatter(self, pages: Sequence[int], k: torch.Tensor, v: torch.Tensor,
                shard: Optional[Tuple[int, int]] = None) -> None:
        """Write [L, n, page, KV, hd] tensors that already lie on this pool's
        device into ``pages``, cast to this pool's dtype, on the current
        stream (part ``shard``'s KV heads with ``shard``)."""
        kt, vt = self._part(shard)
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=kt.device)
        kt[:, idx] = k.to(self.dtype)
        vt[:, idx] = v.to(self.dtype)

    def write_token_range(self, page_ids: Sequence[int], offsets: Sequence[int],
                          k: torch.Tensor, v: torch.Tensor) -> None:
        """Write per-token K/V across all layers: ``k``/``v`` [L, T, KV, hd]
        land at (``page_ids[t]``, ``offsets[t]``), cast to this pool's dtype
        (on the card, before a copy to the host), on the current stream; a
        sharded pool takes each shard's KV heads.  The suffix prefill fills
        a copy-on-write page from an arbitrary token offset with it."""
        n = self.num_shards
        for kt, vt, ks, vs in zip(self.shard_k, self.shard_v, k.chunk(n, dim=2),
                                  v.chunk(n, dim=2)):
            dev = kt.device
            ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
            offs = torch.as_tensor(list(offsets), dtype=torch.long, device=dev)
            kt[:, ids, offs] = ks.to(self.dtype).to(dev)
            vt[:, ids, offs] = vs.to(self.dtype).to(dev)


def copy_async(t: torch.Tensor, device: torch.device, stream
               ) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
    """Copy ``t`` to ``device`` on ``stream`` without blocking the host:
    device to host into pinned memory, host to device from pinned memory
    (``t`` is staged there first when it is not pinned).  Returns the copy
    and an event recorded on ``stream`` after it; the copy may be read once
    the event has completed.  With no card on either side the copy is a
    plain one and the event None."""
    if t.device.type != "cuda" and device.type != "cuda":
        return t.to(device, copy=True), None
    with torch.cuda.stream(stream):
        if device.type == "cpu":
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
        else:
            src = t if t.is_pinned() else t.pin_memory()
            dst = src.to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
    return dst, ev


class DualPool:
    """Device + host pools plus whole-request swap (the scheduler's swap-in/out)."""

    def __init__(self, cfg: ArchConfig, device_pages: int, host_pages: int,
                 *, device=None, shard_devices: Optional[Sequence[torch.device]] = None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.page_size = cfg.kv_block_size
        self.device = PagePool(cfg, device_pages, backend="device", device=dev,
                               shard_devices=shard_devices)
        self.host = PagePool(cfg, host_pages, backend="host", device=dev)
        # PCIe traffic accounting at the host pool's byte width
        self.swap_bytes = 0
        self._swap_lock = threading.Lock()

    def add_swap_bytes(self, n: int) -> None:
        with self._swap_lock:
            self.swap_bytes += n

    def pool(self, location: str) -> PagePool:
        return self.device if location == "gpu" else self.host

    def swap_request(self, req, to: str) -> None:
        """Move a request's whole KV between pools. ``to``: "gpu" | "cpu".

        Blocking whole-request copy — the serial execution path.
        """
        src = self.device if to == "cpu" else self.host
        dst = self.host if to == "cpu" else self.device
        if not req.pages:
            req.location = "gpu" if to == "gpu" else "cpu"
            return
        k, v = src.read_pages(req.pages)
        new_pages = dst.alloc(len(req.pages))
        dst.put_pages(new_pages, k, v)
        src.free(req.pages)
        req.pages = new_pages
        req.location = "gpu" if to == "gpu" else "cpu"
        self.add_swap_bytes(2 * k.numel() * self.host.k.element_size())
