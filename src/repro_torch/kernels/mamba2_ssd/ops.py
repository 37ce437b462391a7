"""Wrapper of the chunked Mamba2 SSD kernel, and the one-token decode step.

:func:`mamba2_ssd` takes the JAX package's layouts (x ``[B, T, H, P]``, dt
``[B, T, H]``, A and D ``[H]``, B/C ``[B, T, N]``, state ``[B, H, N, P]``)
and checks dtype, device, shape and contiguity.  CPU tensors go to the plain
version in :mod:`.ref`; CUDA tensors go to the hand-written kernel
(``csrc/mamba2_ssd.cu``, built with nvcc and bound with ctypes): three
chunk-parallel stages (chunk states, state passing, chunk outputs), which
launch on the current stream without synchronising and share f32 scratch
that this wrapper allocates.  There is no fallback from the kernel to the
plain version: a CUDA input the kernel cannot take, a failed build or a
refused launch raises.  The kernel takes any T (the tail chunk is masked),
any P and any N <= 128; x, B and C in float32 or bfloat16 (one dtype), dt,
A, D and the state in float32.  Unlike
the TPU wrapper, ``x·dt`` and ``dt·A`` are formed inside the kernel and
the ``D·x`` skip is added there too, before y is rounded to x's dtype.

``mamba2_ssd.launches`` counts calls that launched the kernel (one per call
on CUDA tensors); ``mamba2_ssd.stage_launches`` counts the stages launched
(three per call, one when T = 0: only the state pass runs).
:func:`mamba2_decode_step` is the plain single-token recurrence
(the reference's ``ops.mamba2_decode_step``; no TPU kernel behind it).

A real CUDA tensor launches the kernel directly, through
``repro_torch.roofline.opcount.launch``, which counts the call as the op
:data:`OP` in an active counter; a ``meta`` or fake tensor goes through
:data:`OP`, ``repro_torch::mamba2_ssd``, a ``torch.library`` custom op whose
real implementation is the same launch and whose fake implementation gives
an empty output of the right shape and launches nothing, so a traced step
(``repro_torch.launch.dryrun``) passes through the wrapper. The op's
dispatch costs the card's host 19-39 µs a call, so real tensors skip it
(``benchmarks/op_dispatch.py``). :func:`work` is the kernel's work (bytes
and FLOPs) as a function of its inputs' shapes, which the kernel table's
bound and the roofline's counter both read.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked
from repro_torch.roofline.opcount import launch as counted_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"

CHUNK = 64  # tokens per chunk, fixed in the kernel (kChunk)
MAX_N = 128  # state size the kernel's shared-memory tiles hold
MAX_GRID_YZ = 65535  # heads on grid.y, rows on grid.z
HEADS_PER_BLOCK = 4  # heads of one (row, chunk) that a block of stages 1 and 3 walks
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, A, Bm, Cm, D, state0) -> None:
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "state0": state0}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/Bm/Cm must share float32 or bfloat16, got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("state0", state0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.ndim != 4 or Bm.ndim != 3:
        raise ValueError(f"x must be [B, T, H, P] and Bm [B, T, N], got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (B, T, H), "A": (H,), "Bm": (B, T, N), "Cm": (B, T, N), "D": (H,),
            "state0": (B, H, N, P)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} {tuple(tensors[name].shape)} does not fit x "
                             f"{tuple(x.shape)} (want {shape})")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(SOURCE).mamba2_ssd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(N: int, dtype: torch.dtype = torch.bfloat16, stage: int = 3) -> int:
    """Dynamic shared memory a block of ``stage`` (1, 2 or 3) asks for at
    state size N and x's ``dtype`` (built on first use)."""
    fn = _build.load(SOURCE).mamba2_ssd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_size_t
    return int(fn(N, _DTYPE_CODE[dtype], stage))


def _launch(x, dt, A, Bm, Cm, D, state0,
            heads_per_block=HEADS_PER_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if N > MAX_N or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"kernel limits: state size {N} <= {MAX_N}, heads {H} and rows {B} "
                         f"<= {MAX_GRID_YZ} (grid.y, grid.z)")
    y = torch.empty_like(x)
    sT = torch.empty_like(state0)
    if B == 0 or H == 0 or P == 0:
        return y, sT
    fn = _kernel()
    n_chunks = -(-T // CHUNK)
    # stage 1 writes each chunk's state contribution L here, stage 2 the
    # chunk's incoming state over it, stage 3 reads it: [B, chunks, H, N, P
    # rounded up to 4]; tot holds each chunk's total log decay
    scratch = torch.empty(B * n_chunks * H * N * (-(-P // 4) * 4), dtype=torch.float32,
                          device=x.device)
    tot = torch.empty(B * n_chunks * H, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 D.data_ptr(), state0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                 scratch.data_ptr(), tot.data_ptr(),
                 B, T, H, P, N, _DTYPE_CODE[x.dtype], heads_per_block, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: cudaError_t {err}")
    mamba2_ssd.launches += 1
    mamba2_ssd.stage_launches += 3 if n_chunks else 1
    return y, sT


def work(x, dt, A, Bm, Cm, D, state0) -> Tuple[int, int]:
    """(bytes, FLOPs) of one call: each input and output byte once;
    5 N P operations per token per head (the recurrence's own count:
    S <- a S + B (dt x), y = C.S)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    ins = (x, dt, A, Bm, Cm, D, state0)
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + x.numel() * x.element_size() + state0.numel() * 4)
    return nbytes, 5 * N * P * B * T * H


@torch.library.custom_op("repro_torch::mamba2_ssd", mutates_args=())
def _op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor,
        state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(x, dt, A, Bm, Cm, D, state0)


@_op.register_fake
def _(x, dt, A, Bm, Cm, D, state0):
    return torch.empty_like(x), torch.empty_like(state0)


OP = torch.ops.repro_torch.mamba2_ssd
OP_WORK = work


def mamba2_ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    state0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD recurrence over T tokens: (y [B, T, H, P] in x's
    dtype, final state [B, H, N, P] f32).  See the module docstring."""
    _check(x, dt, A, Bm, Cm, D, state0)
    if x.device.type == "cpu":
        return mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, state0, chunk=CHUNK)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    if isinstance(x, FakeTensor) or x.device.type == "meta":
        return OP(x, dt, A, Bm, Cm, D, state0)
    # a real CUDA tensor skips the op's dispatch (its host time; PERF.md)
    return counted_launch(OP, _launch, x, dt, A, Bm, Cm, D, state0)


mamba2_ssd.launches = 0
mamba2_ssd.stage_launches = 0


def mamba2_decode_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, N]
    Cm: torch.Tensor,  # [B, N]
    D: torch.Tensor,  # [H]
    state: torch.Tensor,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode: O(1) in sequence length."""
    x32, dt32, B32, C32 = (a.float() for a in (x, dt, Bm, Cm))
    a = torch.exp(dt32 * A.float()[None])
    upd = (dt32[..., None] * x32)[:, :, None, :] * B32[:, None, :, None]
    state = a[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", C32, state) + D.float()[None, :, None] * x32
    return y.to(x.dtype), state
