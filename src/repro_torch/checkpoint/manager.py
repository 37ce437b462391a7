"""Atomic checkpoint store, the port of the JAX package's
``checkpoint/manager.py``, with its layout.

``<dir>/step_<N>/`` holds ``params.npz``, ``opt_state.npz`` and a JSON
manifest (step, config fingerprint, extra, format).  Writes go to
``<dir>/.tmp_<N>`` first, then ``os.rename``: a crashed save never corrupts
the latest checkpoint (rename is atomic on POSIX).  The ``keep`` most recent
checkpoints are kept.

A tree (the parameters: a state dict; the optimizer state: nested dicts)
is flattened to one npz entry per leaf, its key path joined by ``"\\x1d"``.
numpy has no bfloat16 of its own, so a bfloat16 leaf is stored as its
``uint16`` bit pattern and restored through the template's dtype, bit for
bit.

On a mesh (SPMD, one process per rank) every rank calls :meth:`save` and
:meth:`restore`: the DTensor leaves are gathered whole (``full_tensor``),
rank 0 alone writes and publishes, and the ranks meet at a barrier; on
restore every rank reads the files and lays each leaf out as its template
is laid out.  The files are the single-device format, so a checkpoint made
on one device resumes on a mesh and the other way round.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import full_tensor

Tree = Mapping[str, Any]

_SEP = "\x1d"  # key-path separator inside npz archives


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + _SEP))
        else:
            flat[key] = v
    return flat


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = full_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, DTensor):
        return distribute_tensor(t.to(like.to_local().device, like.dtype), like.device_mesh,
                                 like.placements, src_data_rank=None)
    return t.to(like.device, like.dtype)


def _unflatten_into(template: Tree, flat: Mapping[str, np.ndarray], prefix: str = ""):
    out: Dict[str, Any] = {}
    for k, v in template.items():
        key = prefix + str(k)
        if isinstance(v, Mapping):
            out[k] = _unflatten_into(v, flat, key + _SEP)
        else:
            out[k] = _from_numpy(flat[key], v)
    return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, fingerprint: str = ""):
        self.dir = directory
        self.keep = keep
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name[5:]))
        return sorted(out)

    # ------------------------------------------------------------------
    def save(self, step: int, params: Tree, opt_state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> str:
        tmp = os.path.join(self.dir, f".tmp_{step:08d}")
        final = self._step_dir(step)
        arrays = {name: {k: _to_numpy(t) for k, t in _flatten(tree).items()}
                  for name, tree in (("params", params), ("opt_state", opt_state))}
        if _rank() != 0:
            _barrier()
            return final
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, flat in arrays.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        manifest = {"step": step, "fingerprint": self.fingerprint,
                    "extra": extra or {}, "format": 1}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._rotate()
        _barrier()
        return final

    def _rotate(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, params_template: Optional[Tree] = None,
                opt_template: Optional[Tree] = None) -> Dict[str, Any]:
        """{"step", "extra", "params", "opt_state"}: each tree rebuilt in its
        template's structure, dtypes and devices, or the flat
        {key path: array} without one."""
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if self.fingerprint and manifest["fingerprint"] != self.fingerprint:
            raise ValueError(f"checkpoint fingerprint mismatch: {manifest['fingerprint']!r} "
                             f"!= {self.fingerprint!r}")
        out: Dict[str, Any] = {"step": manifest["step"], "extra": manifest["extra"]}
        for name, template in (("params", params_template), ("opt_state", opt_template)):
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                flat = dict(z)
            out[name] = flat if template is None else _unflatten_into(template, flat)
        return out

    def restore_latest(self, params_template: Optional[Tree] = None,
                       opt_template: Optional[Tree] = None) -> Optional[Dict[str, Any]]:
        steps = self.steps()
        if not steps:
            return None
        return self.restore(steps[-1], params_template, opt_template)
