"""Wrapper of the paged decode attention kernel.

:func:`paged_decode_attention` takes the JAX package's layouts (q
``[B, H, hd]``, pages ``[P, page, KV, hd]``, int32 block tables and lens)
and checks dtype, device, shape and contiguity.  CPU tensors go to the plain
version in :mod:`.ref`; CUDA tensors go to the hand-written kernel
(``csrc/paged_decode.cu``, built with nvcc and bound with ctypes), which
launches on the current stream without synchronising.  There is no fallback
from the kernel to the plain version: a CUDA input the kernel cannot take,
a failed build or a refused launch raises.  Unlike the TPU wrapper, nothing
is padded: the kernel takes as they are pages of up to 32 tokens, any
head_dim up to 256 whose row is a whole number of 16-byte copies (a
multiple of 8 in bf16, of 4 in fp32) on 16-byte aligned K/V pages, and any
group whose output is at most 1,024 such 16-byte slices (qpk x hd x bytes
/ 16: one thread each).

Each row's pages split into ranges of ``PAGES_PER_SPLIT`` pages
(:func:`split_pages`), so a row's output depends on its own length only and
is bitwise the same in any batch (the decode passes of the serial engine,
batch-0 and the open-loop runs share rows in different batches).

``paged_decode_attention.launches`` counts launches of the attention kernel
(one per call on a CUDA tensor); ``paged_decode_attention.merge_launches``
counts launches of the merge kernel that follows it when the block table
holds more than one range.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode.ref import paged_decode_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_decode.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_PAGE = 32  # lane t of a warp keeps token t's probability
MAX_THREADS = 1024  # one thread per 16-byte slice of the group's output
MAX_HEAD_DIM = 256
MAX_SMEM = 227 * 1024  # the opt-in dynamic shared memory of one block (sm_90)
LOAD_BYTES = 16  # pages are staged in shared memory with 16-byte cp.async copies
STAGES = 3  # pages in flight per block (the kernel's kStages)
MIN_THREADS = 128
# Pages per range.  Fixed, so that a row's ranges depend on its own length
# only.  Chosen on the card from chip_smoke.py's sweep of 4, 8, 16 and 32
# at its two timed shapes (B=8 rows of 257-800 tokens; B=64 rows of 2048):
# smaller ranges fill the 132 SMs when a pass has few rows, larger ones
# cut the partials' traffic and the merge when it has many (PERF.md).
PAGES_PER_SPLIT = 8

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


def split_pages(n_pages: int, pages_per_split: int = PAGES_PER_SPLIT) -> List[Tuple[int, int]]:
    """The page ranges ``[begin, end)`` of a row of ``n_pages`` pages: runs
    of ``pages_per_split`` pages, the last one shorter.  They depend on the
    row's own page count only (none for an empty row)."""
    return [(p, min(p + pages_per_split, n_pages)) for p in range(0, n_pages, pages_per_split)]


def smem_bytes(hd: int, page: int, qpk: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one attention block (the kernel's
    ``smem_size``): a ring of STAGES K and V pages in ``dtype``, rows padded
    to 16 words past a multiple of 32; then, in f32, the group's queries,
    one page of probabilities per head, (corr, m, l) per head and one
    16-byte slice per thread for the final sum."""
    el = torch.empty((), dtype=dtype).element_size()
    words = hd * el // 4
    ld = hd + ((16 - words % 32) % 32) * 4 // el
    return STAGES * 2 * page * ld * el + 4 * (
        qpk * hd + qpk * page + 3 * qpk + _threads(qpk, hd, el) * (LOAD_BYTES // el))


def _threads(qpk: int, hd: int, el: int) -> int:
    """Threads per block: one per 16-byte output slice of the group, times
    the token subsets that bring a small group up to MIN_THREADS."""
    items = qpk * hd * el // LOAD_BYTES
    t = items * (1 if items >= MIN_THREADS else MIN_THREADS // max(items, 1))
    return max(MIN_THREADS, -(-t // 32) * 32)


def check_kernel_limits(q, k_pages, v_pages) -> None:
    """Raise ValueError for inputs the kernel cannot take as they are."""
    _, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    el = q.element_size()
    if hd * el % LOAD_BYTES:
        raise ValueError(f"head_dim {hd} x {el} bytes is not a multiple of "
                         f"{LOAD_BYTES} bytes (the kernel stages pages with "
                         f"{LOAD_BYTES}-byte copies)")
    threads = _threads(H // KV, hd, el)
    smem = smem_bytes(hd, page, H // KV, q.dtype)
    if page > MAX_PAGE or hd > MAX_HEAD_DIM or threads > MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(f"kernel limits: page {page} <= {MAX_PAGE}, head_dim {hd} <= "
                         f"{MAX_HEAD_DIM}, threads {threads} (one per 16-byte slice of "
                         f"the group's output) <= {MAX_THREADS}, shared memory {smem} "
                         f"<= {MAX_SMEM}")
    if (k_pages.data_ptr() | v_pages.data_ptr()) % LOAD_BYTES:
        raise ValueError(f"k/v pages must start on a {LOAD_BYTES}-byte boundary")


def _launch(q, k_pages, v_pages, block_tables, lens,
            pages_per_split: int = PAGES_PER_SPLIT) -> torch.Tensor:
    check_kernel_limits(q, k_pages, v_pages)
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    max_pages = block_tables.shape[1]
    # grid.z: the most ranges a row of this block table can have
    n_slots = max(1, len(split_pages(max_pages, pages_per_split)))
    # per (row, kv head, range, query head): unnormalised acc, then l and m
    part = (torch.empty(B * KV * n_slots * (H // KV) * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_slots > 1 else None)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 B, H, KV, hd, page, max_pages, pages_per_split, 1.0 / math.sqrt(hd),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.merge_launches += int(n_slots > 1)
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
