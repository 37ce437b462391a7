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
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

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
    ):
        self.cfg = cfg
        self.backend = backend
        self.page_size = cfg.kv_block_size
        self.num_pages = num_pages
        L = num_layers if num_layers is not None else cfg.num_attention_layers
        self.num_layers = L
        shape = (L, num_pages, self.page_size, cfg.num_kv_heads, cfg.head_dim)
        if backend == "device":
            self.dtype = torch_dtype(cfg.activation_dtype)
            self.k = torch.zeros(shape, dtype=self.dtype, device=device)
            self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        elif backend == "host":
            self.dtype = torch.float32 if cfg.activation_dtype == "float32" else torch.float16
            pin = device.type == "cuda"
            self.k = torch.zeros(shape, dtype=self.dtype, pin_memory=pin)
            self.v = torch.zeros(shape, dtype=self.dtype, pin_memory=pin)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.pinned = self.k.is_pinned()  # a host pool beside a card
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

    # -- page I/O ----------------------------------------------------------------
    def read_pages(self, pages: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of ``pages`` across all layers, [L, n, page, KV, hd], on
        this pool's device and in its dtype."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k.device)
        return self.k[:, idx], self.v[:, idx]

    def put_pages(self, pages: List[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """Write [L, n, page, KV, hd] into ``pages``, cast to this pool's
        dtype and moved to its device.  Casts run on the card (before a
        device→host copy, after a host→device one), so only the host pool's
        byte width crosses PCIe."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k.device)
        dev = self.k.device
        if self.backend == "device":
            k, v = k.to(dev).to(self.dtype), v.to(dev).to(self.dtype)
        else:
            k, v = k.to(self.dtype).to(dev), v.to(self.dtype).to(dev)
        self.k[:, idx] = k
        self.v[:, idx] = v

    def gather(self, pages: Sequence[int], dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of whole ``pages`` (every layer), [L, n, page, KV, hd], on
        this pool's device in ``dtype`` (this pool's by default), enqueued on
        the current stream: a snapshot that later writes to the pages do not
        change once the stream has run it.  A pinned pool gathers into pinned
        memory, so a copy to the card reads the snapshot as it is."""
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.k.device)
        dtype = dtype or self.dtype

        def select(t: torch.Tensor) -> torch.Tensor:
            if not self.pinned:
                return t.index_select(1, idx)
            out = torch.empty((t.shape[0], len(idx), *t.shape[2:]), dtype=t.dtype,
                              pin_memory=True)
            return torch.index_select(t, 1, idx, out=out)

        return select(self.k).to(dtype), select(self.v).to(dtype)

    def scatter(self, pages: Sequence[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """Write [L, n, page, KV, hd] tensors that already lie on this pool's
        device into ``pages``, cast to this pool's dtype, on the current
        stream."""
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.k.device)
        self.k[:, idx] = k.to(self.dtype)
        self.v[:, idx] = v.to(self.dtype)

    def write_token_range(self, page_ids: Sequence[int], offsets: Sequence[int],
                          k: torch.Tensor, v: torch.Tensor) -> None:
        """Write per-token K/V across all layers: ``k``/``v`` [L, T, KV, hd]
        land at (``page_ids[t]``, ``offsets[t]``), cast to this pool's dtype
        (on the card, before a copy to the host), on the current stream.
        The suffix prefill fills a copy-on-write page from an arbitrary token
        offset with it."""
        dev = self.k.device
        ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
        offs = torch.as_tensor(list(offsets), dtype=torch.long, device=dev)
        self.k[:, ids, offs] = k.to(self.dtype).to(dev)
        self.v[:, ids, offs] = v.to(self.dtype).to(dev)


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
                 *, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.page_size = cfg.kv_block_size
        self.device = PagePool(cfg, device_pages, backend="device", device=dev)
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
