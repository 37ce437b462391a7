"""Weight bridge between the JAX package's ``DenseLM.init`` parameter tree
and the port's :class:`~repro_torch.models.transformer.DenseLM`.

The reference tree (``transformer.py:249-271`` of the JAX package) holds
``embed``, ``final_norm``, an optional ``unembed``, ``prefix{i}`` layers and
``blocks/sub{j}`` layers stacked on a leading group axis by ``jax.vmap``;
layer ``i`` of a model with ``P`` prefix layers and ``r`` layers per group is
``prefix{i}`` for ``i < P`` and ``blocks/sub{j}[g]`` with
``i = P + g*r + j`` otherwise.  Leaves arrive as numpy arrays (the caller
converts jax arrays with ``np.asarray``); leaf layouts are the same on both
sides, so the bridge only renames and unstacks.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.config import ArchConfig

Tree = Dict[str, Any]
_LAYER = re.compile(r"layers\.(\d+)\.(.+)")


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy<->torch path
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy().copy()


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _layout(tree: Mapping[str, Any]):
    n_prefix = sum(1 for k in tree if k.startswith("prefix"))
    subs = sorted(tree.get("blocks", {}), key=lambda s: int(s[3:]))
    return n_prefix, len(subs)


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's state dict (CPU tensors)."""
    n_prefix, r = _layout(tree)
    state: Dict[str, torch.Tensor] = {}
    for k in ("embed", "final_norm", "unembed"):
        if k in tree:
            state[k] = _to_tensor(tree[k])
    for i in range(n_prefix):
        for name, leaf in _flatten(tree[f"prefix{i}"]).items():
            state[f"layers.{i}.{name}"] = _to_tensor(leaf)
    for j in range(r):
        for name, leaf in _flatten(tree["blocks"][f"sub{j}"]).items():
            stacked = np.asarray(leaf)
            for g in range(stacked.shape[0]):
                state[f"layers.{n_prefix + g * r + j}.{name}"] = _to_tensor(stacked[g])
    n_layers = len({m.group(1) for m in map(_LAYER.match, state) if m})
    if n_layers != cfg.num_layers:
        raise ValueError(f"reference tree holds {n_layers} layers, "
                         f"{cfg.name} has {cfg.num_layers}")
    return state


def params_to_reference(state: Mapping[str, torch.Tensor], cfg: ArchConfig,
                        *, n_prefix: int = 0, per_group: int = 1) -> Tree:
    """The port's state dict -> a reference-shaped tree of numpy arrays
    (the inverse of :func:`params_from_reference`)."""
    tree: Tree = {}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for k, t in state.items():
        m = _LAYER.match(k)
        if m is None:
            tree[k] = _to_numpy(t)
        else:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = _to_numpy(t)

    def nest(flat: Mapping[str, np.ndarray]) -> Tree:
        out: Tree = {}
        for name, a in flat.items():
            node = out
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = a
        return out

    for i in range(n_prefix):
        tree[f"prefix{i}"] = nest(layers[i])
    n_groups = (cfg.num_layers - n_prefix) // per_group
    blocks: Tree = {}
    for j in range(per_group):
        idx = [n_prefix + g * per_group + j for g in range(n_groups)]
        names = layers[idx[0]].keys()
        blocks[f"sub{j}"] = nest({n: np.stack([layers[i][n] for i in idx]) for n in names})
    tree["blocks"] = blocks
    return tree


def load_reference_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a reference parameter tree into ``model`` (strict: every leaf
    must match a parameter of the same shape)."""
    state = params_from_reference(tree, model.cfg)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for k, t in state.items():
            if tuple(t.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: reference shape {tuple(t.shape)} != "
                                 f"port shape {tuple(own[k].shape)}")
            own[k].copy_(t.to(own[k].dtype))
    return model
