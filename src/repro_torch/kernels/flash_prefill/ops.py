"""Wrapper of the flash prefill attention kernels.

:func:`flash_prefill` takes the JAX package's layouts (q ``[B, S, H, hd]``,
k/v ``[B, S, KV, hd]``) and checks dtype, device, shape and contiguity.  CPU
tensors go to the plain version in :mod:`.ref`; CUDA tensors go to one of
two hand-written kernels in ``csrc/flash_prefill.cu`` (built with nvcc and
bound with ctypes), routed by dtype: bf16 to the tensor-core kernel (wgmma
products, TMA-fed K/V ring; head_dim a multiple of 16, up to 256), fp32 to
the CUDA-core kernel (f32 products, so the 2e-3 gate holds; head_dim up to
256 in whole 16-byte loads, a multiple of 4).  Each launches on the current
stream without synchronising.  There is no fallback: a CUDA input the
kernel of its dtype cannot take, a failed build or a refused launch raises;
nothing runs the plain version or the other kernel in its place.  Unlike
the TPU wrapper, nothing is padded: any S is taken (the ragged last tile is
masked).

``flash_prefill.launches`` counts kernel launches (one per call on CUDA
tensors, either kernel).

A real CUDA tensor launches the kernel directly, through
``repro_torch.roofline.opcount.launch``, which counts the call as the op
:data:`OP` in an active counter; a ``meta`` or fake tensor goes through
:data:`OP`, ``repro_torch::flash_prefill``, a ``torch.library`` custom op
whose real implementation is the same launch and whose fake implementation
gives an empty output of the right shape and launches nothing, so a traced
step (``repro_torch.launch.dryrun``) passes through the wrapper. The op's
dispatch costs the card's host 19-39 µs a call, so real tensors skip it
(``benchmarks/op_dispatch.py``). :func:`work` is the kernel's work (bytes
and FLOPs) as a function of its inputs' shapes, which the kernel table's
bound and the roofline's counter (``repro_torch.roofline.opcount``) both
read.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.roofline.opcount import launch as counted_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_prefill.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535  # heads (bf16: kv heads x head pairs) on grid.y, rows on grid.z
MAX_SMEM = 227 * 1024  # the opt-in dynamic shared memory of one block (sm_90)
LOAD_BYTES = 16  # tiles are staged in shared memory with 16-byte loads (and TMA rows)
TC_K = 16  # bf16 kernel: wgmma's k-depth
TC_CHUNK = 64  # bf16 kernel: head dims per 128-byte swizzled tile chunk


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_prefill takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v must be {q.dtype}, got {k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(SOURCE)
    lib.flash_prefill.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_prefill.restype = ctypes.c_int
    lib.flash_prefill_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_prefill_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel ``dtype`` takes (the
    kernels' formulas; the wrapper checks them without building).  bf16:
    1 KiB of alignment slack, the two consumer warpgroups' query tiles and
    a ring of K and V tiles (3 stages up to hd = 128, else 2), each tile
    [64][64 x ceil(hd / 64)] bf16, then the barriers.  fp32: three
    [64, hd + 1] tiles (q, k, v) and the [64, 65] f32 probabilities."""
    if dtype == torch.bfloat16:
        nch = -(-hd // TC_CHUNK)
        stages = 3 if nch <= 2 else 2
        return 1024 + (2 + 2 * stages) * nch * 64 * TC_CHUNK * 2 + 128
    el = torch.empty((), dtype=dtype).element_size()
    return 3 * 64 * (hd + 4 // el) * el + 64 * 65 * 4


def check_kernel_limits(q, k, v) -> None:
    """Raise ValueError for inputs the kernel of q's dtype cannot take as
    they are."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    el = q.element_size()
    tc = q.dtype == torch.bfloat16
    grid_y = KV * -(-(H // KV) // 2) if tc else H
    if hd > MAX_HEAD_DIM or grid_y > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"kernel limits: head_dim {hd} <= {MAX_HEAD_DIM}, grid.y {grid_y} "
                         f"and rows {B} <= {MAX_GRID_YZ} (grid.y, grid.z)")
    if tc and hd % TC_K:
        raise ValueError(f"head_dim {hd} is not a multiple of {TC_K} (the bf16 kernel's "
                         f"wgmma k-depth)")
    if hd * el % LOAD_BYTES:
        raise ValueError(f"head_dim {hd} x {el} bytes is not a multiple of "
                         f"{LOAD_BYTES} bytes (the kernel stages tiles with "
                         f"{LOAD_BYTES}-byte loads)")
    if smem_bytes(hd, q.dtype) > MAX_SMEM:
        raise ValueError(f"shared memory {smem_bytes(hd, q.dtype)} > {MAX_SMEM} bytes")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % LOAD_BYTES:
        raise ValueError(f"q/k/v must start on a {LOAD_BYTES}-byte boundary")


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    check_kernel_limits(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                B, S, H, k.shape[2], hd, int(causal), int(window),
                                1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError_t {err}")
    flash_prefill.launches += 1
    return out


def prefill_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head attends over at length S."""
    if not causal and not window:
        return S * S
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i if causal else S - 1
        total += hi - lo + 1
    return total


def work(q, k, v, causal: bool = True, window: int = 0) -> Tuple[int, int]:
    """(bytes, FLOPs) of one call: q, k, v and the output once; 4 hd FLOPs
    (QK^T and PV) per (query, key) pair a head sees (half the square when
    causal)."""
    B, S, H, hd = q.shape
    el = q.element_size()
    return (2 * q.numel() * el + 2 * k.numel() * el,
            4 * hd * B * H * prefill_pairs(S, causal, window))


@torch.library.custom_op("repro_torch::flash_prefill", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        window: int) -> torch.Tensor:
    return _launch(q, k, v, causal, window)


@_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


OP = torch.ops.repro_torch.flash_prefill
OP_WORK = work


def flash_prefill(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd]
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Prefill attention of every query over the keys it sees (causal and/or
    within ``window``); output [B, S, H, hd] in q's dtype.  See the module
    docstring for the launch counter."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if isinstance(q, FakeTensor) or q.device.type == "meta":
        return OP(q, k, v, causal, window)
    # a real CUDA tensor skips the op's dispatch (its host time; PERF.md)
    return counted_launch(OP, _launch, q, k, v, causal, window)


flash_prefill.launches = 0
