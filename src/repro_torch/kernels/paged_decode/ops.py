"""Wrapper of the paged decode attention kernel.

:func:`paged_decode_attention` takes the JAX package's layouts (q
``[B, H, hd]``, pages ``[P, page, KV, hd]``, int32 block tables and lens)
and checks dtype, device, shape and contiguity.  CPU tensors go to the plain
version in :mod:`.ref`; CUDA tensors go to the hand-written kernel
(``csrc/paged_decode.cu``, built with nvcc and bound with ctypes), which
launches on the current stream without synchronising.  There is no fallback
from the kernel to the plain version: a CUDA input the kernel cannot take,
a failed build or a refused launch raises.  Unlike the TPU wrapper, nothing
is padded: the kernel takes as they are any group size up to 32 and any
head_dim up to 256 whose row is a whole number of 16-byte loads (a multiple
of 8 in bf16, of 4 in fp32), on 16-byte aligned K/V pages.

``paged_decode_attention.launches`` counts launches of the attention kernel
(one per call on a CUDA tensor); ``paged_decode_attention.merge_launches``
counts launches of the merge kernel that follows it when the rows' pages
are split into ranges (see :func:`split_pages`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode.ref import paged_decode_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_decode.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_PAGE = 32  # lane t of a warp keeps token t's score
MAX_GROUP = 32  # one warp per query head of a group, 1024 threads at most
MAX_HEAD_DIM = 256
MAX_SMEM = 48 * 1024  # static launch limit without an opt-in attribute
LOAD_BYTES = 16  # pages are staged in shared memory with 16-byte loads
BLOCKS_PER_SM = 8  # page-range split target (see split_pages)
MIN_PAGES_PER_SPLIT = 4


def _check(q, k_pages, v_pages, block_tables, lens) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lens": lens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"k/v pages must be {q.dtype}, got {k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != hd or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(k_pages.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lens "
                         f"{tuple(lens.shape)} do not match {B} rows")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(SOURCE).paged_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_pages(rows_x_kv: int, max_pages: int, sm_count: int) -> int:
    """How many contiguous page ranges to split each row into, so that
    ``rows_x_kv * n`` blocks give every SM about ``BLOCKS_PER_SM`` blocks,
    with at least ``MIN_PAGES_PER_SPLIT`` pages per range and no empty
    trailing range."""
    want = -(-BLOCKS_PER_SM * sm_count // max(rows_x_kv, 1))
    n = max(1, min(want, -(-max_pages // MIN_PAGES_PER_SPLIT)))
    per = -(-max_pages // n)
    return -(-max_pages // per)


def check_kernel_limits(q, k_pages, v_pages) -> None:
    """Raise ValueError for inputs the kernel cannot take as they are."""
    _, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    el = q.element_size()
    smem = 2 * page * hd * el
    if page > MAX_PAGE or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM or smem > MAX_SMEM:
        raise ValueError(f"kernel limits: page {page} <= {MAX_PAGE}, group {H // KV} <= "
                         f"{MAX_GROUP}, head_dim {hd} <= {MAX_HEAD_DIM}, "
                         f"shared memory {smem} <= {MAX_SMEM}")
    if hd * el % LOAD_BYTES:
        raise ValueError(f"head_dim {hd} x {el} bytes is not a multiple of "
                         f"{LOAD_BYTES} bytes (the kernel stages pages with "
                         f"{LOAD_BYTES}-byte loads)")
    if (k_pages.data_ptr() | v_pages.data_ptr()) % LOAD_BYTES:
        raise ValueError(f"k/v pages must start on a {LOAD_BYTES}-byte boundary")


def _launch(q, k_pages, v_pages, block_tables, lens) -> torch.Tensor:
    check_kernel_limits(q, k_pages, v_pages)
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    max_pages = block_tables.shape[1]
    n_split = split_pages(B * KV, max_pages, _sm_count(q.device.index or 0))
    # per (row, kv head, split, query head): unnormalised acc, then l and m
    part = (torch.empty(B * KV * n_split * (H // KV) * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 B, H, KV, hd, page, max_pages, n_split, 1.0 / math.sqrt(hd),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.merge_launches += int(n_split > 1)
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, page, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, n_pages] int32
    lens: torch.Tensor,  # [B] int32 — tokens to attend over; 0 gives zeros
) -> torch.Tensor:
    """Attention of one query token per row over its pages; output in q's
    dtype.  See the module docstring for the launch counters."""
    _check(q, k_pages, v_pages, block_tables, lens)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_tables, lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, lens)


paged_decode_attention.launches = 0
paged_decode_attention.merge_launches = 0
