"""Weight bridge between the JAX package's parameter trees and the port's
state dicts, for every family the port serves.

* dense, moe, vlm (``DenseLM``): the reference tree (``transformer.py:249-271``
  of the JAX package) holds ``embed``, ``final_norm``, an optional
  ``unembed``, ``prefix{i}`` layers and ``blocks/sub{j}`` layers stacked on a
  leading group axis by ``jax.vmap``; layer ``i`` of a model with ``P``
  prefix layers and ``r`` layers per group is ``prefix{i}`` for ``i < P``
  and ``blocks/sub{j}[g]`` with ``i = P + g*r + j`` otherwise (deepseek: one
  ``dense0`` prefix layer and groups of one moe layer; llama4: groups of
  ``[moe, dense]``).  A moe layer's leaves sit under ``moe``
  (``router``, ``w_gate [E, d, ff]``, ..., ``shared/*``), the port's
  ``layers.{i}.moe.*``.
* ssm (``RWKV6LM``): ``embed``, ``ln0``, ``final_norm``, ``unembed`` and
  ``blocks`` stacked on ``[L, ...]`` (``rwkv6.py:99-111``); layer ``i`` is
  ``blocks.{i}`` in the port.
* hybrid (``Zamba2LM``): ``embed``, ``final_norm``, ``unembed``, ``shared``
  and the Mamba2 blocks stacked as ``mamba_groups`` [G, per_group, ...] and
  ``mamba_tail`` [tail, ...] (``zamba2.py:71-87``); block ``g*per_group + j``
  and ``G*per_group + t`` are ``mamba.{i}`` in the port.
* audio (``EncDecLM``): ``embed``, ``frame_in``, ``enc_norm``,
  ``final_norm``, ``unembed`` and ``enc_blocks`` / ``dec_blocks`` stacked on
  ``[L, ...]`` (``encdec.py:73-87``); layer ``i`` is ``enc_blocks.{i}`` /
  ``dec_blocks.{i}`` in the port.

Leaves arrive as numpy arrays (the caller converts jax arrays with
``np.asarray``); leaf layouts are the same on both sides, so the bridge only
renames and unstacks.  :func:`shard_state_dict` splits a state dict into
the per-shard column slices of tensor-parallel serving.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.distributed.sharding import gather_tp_spec
from repro_torch.models.transformer import layer_pattern

Tree = Dict[str, Any]


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


def _nest(flat: Mapping[str, np.ndarray]) -> Tree:
    out: Tree = {}
    for name, a in flat.items():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return out


def _unstack(tree: Mapping[str, Any], lead: int, index) -> Dict[str, torch.Tensor]:
    """{port name: tensor} for every slice of the leaves of ``tree``, whose
    ``lead`` leading axes are stacked layers; ``index`` maps the stacked
    position (a tuple) to the port's ``prefix.{i}.``."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree).items():
        stacked = np.asarray(leaf)
        for pos in np.ndindex(*stacked.shape[:lead]):
            state[f"{index(pos)}{name}"] = _to_tensor(stacked[pos])
    return state


def _split_layers(state: Mapping[str, torch.Tensor], prefix: str):
    """({layer: {name: array}}, {top-level name: array}) of a port state dict
    whose layers are ``{prefix}.{i}.{name}``."""
    pat = re.compile(rf"{re.escape(prefix)}\.(\d+)\.(.+)")
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    rest: Dict[str, np.ndarray] = {}
    for k, t in state.items():
        m = pat.match(k)
        if m is None:
            rest[k] = _to_numpy(t)
        else:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = _to_numpy(t)
    return layers, rest


def _stack(layers: Mapping[int, Mapping[str, np.ndarray]], idx) -> Tree:
    names = layers[idx[0]].keys()
    return _nest({n: np.stack([layers[i][n] for i in idx]) for n in names})


def _check_layers(state: Mapping[str, torch.Tensor], prefix: str, n_want: int,
                  cfg: ArchConfig) -> None:
    pat = re.compile(rf"{re.escape(prefix)}\.(\d+)\.")
    n = len({m.group(1) for m in map(pat.match, state) if m})
    if n != n_want:
        raise ValueError(f"reference tree holds {n} layers, {cfg.name} has {n_want}")


def _zamba2_layout(cfg: ArchConfig):
    every = cfg.shared_attn_every
    groups = cfg.num_layers // every
    return groups, every, cfg.num_layers - groups * every


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's state dict (CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        for k in ("embed", "ln0", "final_norm", "unembed"):
            state[k] = _to_tensor(tree[k])
        state.update(_unstack(tree["blocks"], 1, lambda pos: f"blocks.{pos[0]}."))
        _check_layers(state, "blocks", cfg.num_layers, cfg)
        return state
    if cfg.family == "hybrid":
        G, r, _ = _zamba2_layout(cfg)
        for k in ("embed", "final_norm", "unembed"):
            state[k] = _to_tensor(tree[k])
        for name, leaf in _flatten(tree["shared"]).items():
            state[f"shared.{name}"] = _to_tensor(leaf)
        if "mamba_groups" in tree:
            state.update(_unstack(tree["mamba_groups"], 2,
                                  lambda pos: f"mamba.{pos[0] * r + pos[1]}."))
        if "mamba_tail" in tree:
            state.update(_unstack(tree["mamba_tail"], 1,
                                  lambda pos: f"mamba.{G * r + pos[0]}."))
        _check_layers(state, "mamba", cfg.num_layers, cfg)
        return state
    if cfg.family == "audio":
        for k in ("embed", "frame_in", "enc_norm", "final_norm", "unembed"):
            state[k] = _to_tensor(tree[k])
        for stack in ("enc_blocks", "dec_blocks"):
            state.update(_unstack(tree[stack], 1, lambda pos, s=stack: f"{s}.{pos[0]}."))
        _check_layers(state, "enc_blocks", cfg.encdec.encoder_layers, cfg)
        _check_layers(state, "dec_blocks", cfg.num_layers, cfg)
        return state
    n_prefix, r = _layout(tree)
    for k in ("embed", "final_norm", "unembed"):
        if k in tree:
            state[k] = _to_tensor(tree[k])
    for i in range(n_prefix):
        for name, leaf in _flatten(tree[f"prefix{i}"]).items():
            state[f"layers.{i}.{name}"] = _to_tensor(leaf)
    for j in range(r):
        state.update(_unstack(tree["blocks"][f"sub{j}"], 1,
                              lambda pos, j=j: f"layers.{n_prefix + pos[0] * r + j}."))
    _check_layers(state, "layers", cfg.num_layers, cfg)
    return state


def params_to_reference(state: Mapping[str, torch.Tensor], cfg: ArchConfig) -> Tree:
    """The port's state dict -> a reference-shaped tree of numpy arrays
    (the inverse of :func:`params_from_reference`; a decoder's layers are
    stacked by the reference's pattern for ``cfg``)."""
    if cfg.family == "ssm":
        layers, tree = _split_layers(state, "blocks")
        tree["blocks"] = _stack(layers, list(range(cfg.num_layers)))
        return tree
    if cfg.family == "hybrid":
        G, r, tail = _zamba2_layout(cfg)
        layers, rest = _split_layers(state, "mamba")
        tree = _nest(rest)
        if G:
            groups = [_stack(layers, list(range(g * r, (g + 1) * r))) for g in range(G)]
            tree["mamba_groups"] = {n: np.stack([gr[n] for gr in groups])
                                    for n in groups[0]}
        if tail:
            tree["mamba_tail"] = _stack(layers, list(range(G * r, cfg.num_layers)))
        return tree
    if cfg.family == "audio":
        enc, _ = _split_layers(state, "enc_blocks")
        dec, tree = _split_layers({k: state[k] for k in state if not k.startswith("enc_blocks.")},
                                  "dec_blocks")
        tree["enc_blocks"] = _stack(enc, list(range(cfg.encdec.encoder_layers)))
        tree["dec_blocks"] = _stack(dec, list(range(cfg.num_layers)))
        return tree
    prefix, group, _ = layer_pattern(cfg)
    n_prefix, per_group = len(prefix), len(group)
    layers, tree = _split_layers(state, "layers")
    for i in range(n_prefix):
        tree[f"prefix{i}"] = _nest(layers[i])
    n_groups = (cfg.num_layers - n_prefix) // per_group
    tree["blocks"] = {f"sub{j}": _stack(layers, [n_prefix + g * per_group + j
                                                 for g in range(n_groups)])
                      for j in range(per_group)}
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


def shard_state_dict(state: Mapping[str, torch.Tensor], tp: int) -> List[Dict[str, torch.Tensor]]:
    """The port's state dict -> ``tp`` per-shard weight sets by gather-TP's
    rule (:func:`repro_torch.distributed.sharding.gather_tp_spec`): shard
    ``s`` holds the ``s``-th of ``tp`` equal column slices of every
    column-sharded leaf, contiguous and on the leaf's device; replicated
    leaves are not repeated.  Concatenated in shard order along their axis,
    the slices are the unsharded leaves bit for bit."""
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(tp)]
    for name, leaf in state.items():
        axis = gather_tp_spec(name)
        if axis is None:
            continue
        if leaf.shape[axis] % tp:
            raise ValueError(f"{name}: axis {axis} of {tuple(leaf.shape)} does not divide "
                             f"into {tp} shards")
        for s, part in enumerate(leaf.detach().chunk(tp, dim=axis)):
            shards[s][name] = part.contiguous()
    return shards
