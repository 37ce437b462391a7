"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` says
    otherwise.  With no CUDA and no explicit device this raises instead of
    falling back to the CPU, so a run never reports CPU numbers as the card's.
    ``"meta"`` builds shapes without storage."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "meta":  # shapes and dtypes only (the dry run's specs)
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name (``ArchConfig.param_dtype`` /
    ``activation_dtype``, or a cache leaf's dtype name)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}") from None


def new_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream of its own on ``device``; None on the CPU, where every
    op runs in program order anyway."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Context that makes ``stream`` current (a no-op for None: the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

