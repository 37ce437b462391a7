"""Gather-TP: the serving engine's reduction-free tensor parallelism, the
port of the gather-TP half of the JAX package's ``distributed/sharding.py``.

The QKV projections and the MLP up-projections are column-sharded across
the shards; the output and down projections, embeddings, norms and the
unembedding are replicated.  Every cross-shard combine is a concatenation
(:func:`tp_allgather`) in shard order before a replicated contraction, so
the float summation order of every product is the unsharded one and greedy
decode is bitwise the same at any TP degree.

The reference runs one ``shard_map`` program per shard on a ``(1, tp)``
mesh.  The port keeps its single controller: one process and one engine
thread hold the shards' column slices, each on its shard's device (a list
that may name one device more than once), launch each shard's work there,
and concatenate onto the primary device, where the replicated layers run
once.  The reference's logical-axis sharding rules (``ShardingContext``,
``default_rules``) serve multi-device training and the dry run: ROADMAP
P16b ports them.  Single-device training needs none of them (with no
context every reference ``shard()`` is a no-op).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from repro_torch.config import ArchConfig

# the column-sharded leaves among the port's parameter names:
# ``layers.{i}.attn.wq`` [d, H, hd], ``wk``/``wv`` [d, KV, hd] along their
# head axis, and ``layers.{i}.mlp.w_gate``/``w_up`` [d, f] along d_ff
_COLUMN_SHARDED = re.compile(r"(^|\.)(attn\.w[qkv]|mlp\.w_(gate|up))$")


def gather_tp_spec(name: str) -> Optional[int]:
    """The axis along which gather-TP shards the port's parameter ``name``
    (1 for the QKV heads and the MLP's d_ff), or None when it is
    replicated."""
    return 1 if _COLUMN_SHARDED.search(name) else None


def tp_allgather(parts: Sequence[torch.Tensor], axis: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Concatenate the shards' partials along ``axis`` on ``device`` (the
    reference's tiled ``all_gather``): a pure concatenation in shard order.
    The identity for one shard."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=axis)


def check_tp(cfg: ArchConfig, tp: int) -> None:
    """Refuse what the reference's tensor-parallel serving refuses, with its
    messages: any family but the dense one (NotImplementedError), and a
    ``tp`` that does not divide the heads, the KV heads and d_ff
    (ValueError)."""
    if tp <= 1:
        return
    if cfg.moe is not None or cfg.modality is not None:
        raise NotImplementedError("tensor-parallel serving covers the dense family only")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}, "
                         f"num_kv_heads={cfg.num_kv_heads} and d_ff={cfg.d_ff}")
