"""Shared building blocks: norms, rotary embeddings, the SwiGLU MLP,
embedding lookup, logits, the training loss's chunked cross entropy and
activation checkpointing, the initialisers, and the parameter and cache
helpers the models share.

Plain functions on tensors.  Weight layouts follow the JAX package
(``w_gate [d, f]``, ``w_down [f, d]``, ``embed [V, d]``) so the bridge and
the differential tests compare like with like.  Norm, RoPE and SiLU math is
taken in float32 and cast back, as the reference does.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import torch_dtype

Params = Mapping[str, torch.Tensor]

# weight of the MoE load-balance loss in the training loss, per layer
AUX_LOSS_WEIGHT = 1e-2


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------


def param(shape: Sequence[int], dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised, frozen parameter (weights come from ``init`` or a
    loaded state dict).  Serving never needs gradients; only the trainer
    (:mod:`repro_torch.train.trainer`) makes parameters trainable."""
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


# A prefill's column-shardable GEMMs (QKV, SwiGLU gate/up) run at no fewer
# rows than this on the card, at TP=1 and per gather-TP shard alike: below
# it cuBLAS may split K differently for a shard's N/tp columns than for all
# N, and a column's bits move (qwen3-14b's wq under 64 rows, wk at 64-192
# on the H100); at 256 rows and more each shard's columns are the unsharded
# GEMM's (tests/test_torch_tp_card.py).  Decode slices have their own rule
# (core/executor.py::_shard_rows).
PREFILL_MIN_ROWS = 256


def rows_matmul(x: torch.Tensor, w: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """``x @ w`` for x [..., K] and w [K, N], on the card with the rows
    (every axis but the last) padded with zeros to ``min_rows`` and cut
    back: one GEMM of at least ``min_rows`` rows."""
    rows = x.numel() // x.shape[-1]
    if not x.is_cuda or rows >= min_rows:
        return x @ w
    flat = x.reshape(rows, x.shape[-1])
    out = torch.cat([flat, flat.new_zeros(min_rows - rows, flat.shape[1])]) @ w
    return out[:rows].reshape(*x.shape[:-1], w.shape[-1])


def swiglu_hidden(p: Params, x: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """x: [..., d_model] -> the hidden [..., f] before ``w_down`` (a
    tensor-parallel shard passes its d_ff column slice of the weights);
    ``min_rows`` as in :func:`rows_matmul`."""
    gate = rows_matmul(x, p["w_gate"], min_rows)
    up = rows_matmul(x, p["w_up"], min_rows)
    return F.silu(gate.float()).to(x.dtype) * up


def swiglu_apply(p: Params, x: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model]."""
    return swiglu_hidden(p, x, min_rows) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table: [vocab, d_model]; tokens: int [...] -> [..., d_model].  A
    gather; its backward (``embedding_dense_backward``) is deterministic,
    where indexing's accumulating scatter is not on the CPU."""
    return F.embedding(tokens.long(), table)


def logits_last(hidden_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """hidden_last: [B, d] -> float32 logits [B, vocab]."""
    return (hidden_last @ unembed).float()


# ---------------------------------------------------------------------------
# Training: activation checkpointing and the chunked cross entropy
# ---------------------------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs):
    """``"minimal"``'s rule: keep the 2-D weight products (``aten.mm``) and
    recompute everything else, batched products (``aten.bmm``) included."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the arch's activation-checkpointing policy, the
    reference's ``maybe_remat``: ``"none"`` stores every activation,
    ``"full"`` recomputes the whole body in the backward pass, and
    ``"minimal"`` saves the unbatched weight products only (the
    counterpart of ``dots_with_no_batch_dims_saveable``).  ``"sp_save"``
    keeps the sequence-parallel all-gathers, which exist only on a mesh."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if policy == "minimal":
        def contexts():
            return ckpt.create_selective_checkpoint_contexts(_save_weight_products)

        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=contexts)
    if policy == "sp_save":
        raise NotImplementedError(
            "remat_policy 'sp_save' saves sequence-parallel all-gathers, which run "
            "only under a mesh: multi-device training is ROADMAP P16b")
    raise ValueError(f"unknown remat_policy {policy!r}")


def _chunk_xent(h: torch.Tensor, unembed: torch.Tensor, t: torch.Tensor,
                m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = (h @ unembed).float()  # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum(), m.sum()


def softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean cross entropy over ``mask`` without the whole [B, S, V]
    logits: hidden [B, S, d], unembed [d, V], targets [B, S] int, mask
    [B, S] float.  The sequence goes in chunks of ``chunk`` (a tail shorter
    than a chunk is left out, as the reference leaves it), each chunk's
    float32 logits recomputed in the backward pass instead of stored.
    Returns (loss, total weight), the weight at least 1."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    losses, weights = [], []
    for c0 in range(0, max(S // chunk, 1) * chunk, chunk):
        sl = slice(c0, c0 + chunk)
        loss, w = ckpt.checkpoint(_chunk_xent, hidden[:, sl], unembed, targets[:, sl],
                                  mask[:, sl], use_reentrant=False)
        losses.append(loss)
        weights.append(w)
    total_w = torch.clamp(torch.stack(weights).sum(), min=1.0)
    return torch.stack(losses).sum() / total_w, total_w
