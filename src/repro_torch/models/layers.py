"""Shared building blocks: norms, rotary embeddings, the SwiGLU MLP,
embedding lookup, logits, the initialisers, and the parameter and cache
helpers the models share.

Plain functions on tensors.  Weight layouts follow the JAX package
(``w_gate [d, f]``, ``w_down [f, d]``, ``embed [V, d]``) so the bridge and
the differential tests compare like with like.  Norm, RoPE and SiLU math is
taken in float32 and cast back, as the reference does.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import torch_dtype

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------


def param(shape: Sequence[int], dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised, frozen parameter (weights come from ``init`` or a
    loaded state dict)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


def zeros_cache(shapes, device) -> dict:
    """Zero tensors for a model's ``cache_shape`` ({name: (shape, dtype
    name, logical axes)})."""
    return {name: torch.zeros(shp, dtype=torch_dtype(dt), device=device)
            for name, (shp, dt, _) in shapes.items()}


def commit_rows(leaf: torch.Tensor, new: torch.Tensor,
                active: Optional[torch.Tensor]) -> None:
    """Write ``new`` into ``leaf`` (rows on the leading axis) in place, for
    the ``active`` rows only when a mask is given."""
    if active is None:
        leaf.copy_(new)
    else:
        leaf.copy_(torch.where(active.view(-1, *([1] * (new.ndim - 1))), new, leaf))


# ---------------------------------------------------------------------------
# Init helpers (the reference's distributions; the bits differ, since a
# torch.Generator is not a jax.random key)
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the trailing head_dim, per head (RWKV ``ln_x``);
    x: [..., H, N], scale/bias: [H, N]."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split / NeoX form)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_params(d: int, f: int, dtype: torch.dtype, device) -> nn.ParameterDict:
    """SwiGLU weights ``w_gate``/``w_up [d, f]``, ``w_down [f, d]``
    (uninitialised)."""
    return nn.ParameterDict({"w_gate": param((d, f), dtype, device),
                             "w_up": param((d, f), dtype, device),
                             "w_down": param((f, d), dtype, device)})


def init_mlp(mlp: nn.ParameterDict, g: torch.Generator) -> None:
    for n in ("w_gate", "w_up", "w_down"):
        w = mlp[n]
        w.data.copy_(dense_init(g, w.shape, w.shape[0], w.dtype, w.device))


def swiglu_hidden(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., d_model] -> the hidden [..., f] before ``w_down`` (a
    tensor-parallel shard passes its d_ff column slice of the weights)."""
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    return F.silu(gate.float()).to(x.dtype) * up


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model]."""
    return swiglu_hidden(p, x) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table: [vocab, d_model]; tokens: int [...] -> [..., d_model]."""
    return table[tokens.long()]


def logits_last(hidden_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """hidden_last: [B, d] -> float32 logits [B, vocab]."""
    return (hidden_last @ unembed).float()
