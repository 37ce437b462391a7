"""Wrapper of the chunked RWKV6 scan kernel, and the one-token decode step.

:func:`rwkv6_scan` takes the JAX package's layouts (r/k/v/w ``[B, T, H, N]``,
u ``[H, N]``, state ``[B, H, N(key), N(value)]``) and checks dtype, device,
shape and contiguity.  CPU tensors go to the plain version in :mod:`.ref`;
CUDA tensors go to the hand-written kernel (``csrc/rwkv6_scan.cu``, built
with nvcc and bound with ctypes): three chunk-parallel stages (chunk states,
state passing, chunk outputs) that hand the state on every ``STATE_CHUNK``
tokens, launch on the current stream without synchronising and share f32
scratch that this wrapper allocates.  There is no fallback from the kernel
to the plain version: a CUDA input the kernel cannot take, a failed build or a refused
launch raises.  The kernel takes any T (the tail chunk is masked) and any
head size N <= 128; r/k/v in float32 or bfloat16, w, u and the state in
float32.

``rwkv6_scan.launches`` counts calls that launched the kernel (one per call
on CUDA tensors); ``rwkv6_scan.stage_launches`` counts the stages launched
(three per call, one when T = 0: only the state pass runs).
:func:`rwkv6_decode_step` is the plain single-token recurrence
(the reference's ``ops.rwkv6_decode_step``; no TPU kernel behind it).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import STATE_CHUNK, rwkv6_chunked

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"

CHUNK = 16  # tokens per chunk of the plain version (the TPU kernel's chunk)
MAX_N = 128  # head size the kernel's shared-memory tiles hold
MAX_GRID_YZ = 65535  # heads on grid.y, rows on grid.z
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(r, k, v, w, u, state0) -> None:
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "state0": state0}
    for name, t in tensors.items():
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("w", w), ("u", u), ("state0", state0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if r.ndim != 4 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r/k/v/w must share one [B, T, H, N] shape, got "
                         f"{tuple(r.shape)} {tuple(k.shape)} {tuple(v.shape)} {tuple(w.shape)}")
    B, _, H, N = r.shape
    if tuple(u.shape) != (H, N) or tuple(state0.shape) != (B, H, N, N):
        raise ValueError(f"u {tuple(u.shape)} / state0 {tuple(state0.shape)} do not fit "
                         f"r {tuple(r.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(SOURCE).rwkv6_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(N: int, dtype: torch.dtype = torch.bfloat16, stage: int = 3) -> int:
    """Dynamic shared memory a block of ``stage`` (1, 2 or 3) asks for at
    head size N and r's ``dtype`` (built on first use)."""
    fn = _build.load(SOURCE).rwkv6_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_size_t
    return int(fn(N, _DTYPE_CODE[dtype], stage))


def _launch(r, k, v, w, u, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, N = r.shape
    if N > MAX_N or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"kernel limits: head size {N} <= {MAX_N}, heads {H} and rows {B} "
                         f"<= {MAX_GRID_YZ} (grid.y, grid.z)")
    y = torch.empty_like(r)
    sT = torch.empty_like(state0)
    if B == 0 or H == 0 or N == 0:
        return y, sT
    fn = _kernel()
    n_chunks = -(-T // STATE_CHUNK)
    # stage 1 writes each chunk's state contribution L here, stage 2 the
    # chunk's incoming state over it, stage 3 reads it: [B, chunks, H, N, N
    # rounded up to 4]; tot holds each chunk's total log decay per key row
    scratch = torch.empty(B * n_chunks * H * N * (-(-N // 4) * 4), dtype=torch.float32,
                          device=r.device)
    tot = torch.empty(B * n_chunks * H * N, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 state0.data_ptr(), y.data_ptr(), sT.data_ptr(), scratch.data_ptr(),
                 tot.data_ptr(), B, T, H, N, _DTYPE_CODE[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError_t {err}")
    rwkv6_scan.launches += 1
    rwkv6_scan.stage_launches += 3 if n_chunks else 1
    return y, sT


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked RWKV6 recurrence over T tokens: (y [B, T, H, N] in r's
    dtype, final state [B, H, N, N] f32).  See the module docstring."""
    _check(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return rwkv6_chunked(r, k, v, w, u, state0, chunk=CHUNK)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    return _launch(r, k, v, w, u, state0)


rwkv6_scan.launches = 0
rwkv6_scan.stage_launches = 0


def rwkv6_decode_step(
    r: torch.Tensor,  # [B, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    state: torch.Tensor,  # [B, H, N, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode: O(1) in sequence length."""
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    kv = k32[..., :, None] * v32[..., None, :]
    y = torch.einsum("bhj,bhji->bhi", r32, state + u.float()[None, :, :, None] * kv)
    state = w32[..., :, None] * state + kv
    return y.to(r.dtype), state
