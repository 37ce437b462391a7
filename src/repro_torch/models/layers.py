"""Shared building blocks: norms, rotary embeddings, the SwiGLU MLP,
embedding lookup, logits, the training loss's chunked cross entropy and
activation checkpointing, the initialisers, and the parameter and cache
helpers the models share.

The ``shard()`` annotations sit where the reference has them; they act only
on DTensors under an active sharding context
(:mod:`repro_torch.distributed.sharding`) and are the identity otherwise.

Plain functions on tensors.  Weight layouts follow the JAX package
(``w_gate [d, f]``, ``w_down [f, d]``, ``embed [V, d]``) so the bridge and
the differential tests compare like with like.  Norm, RoPE and SiLU math is
taken in float32 and cast back, as the reference does.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as ckpt

from repro_torch.device import torch_dtype
from repro_torch.distributed.sharding import current_context, from_local, local, shard

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


def serving(fn: Callable) -> Callable:
    """Run a serve entry point (``prefill``, ``decode``) under
    ``torch.inference_mode()``, or under ``torch.no_grad()`` inside an
    active sharding context on a mesh: DTensor's views refuse inference
    tensors.  Either way nothing records gradients."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        ctx = current_context()
        with (torch.no_grad() if ctx is not None and ctx.distributed
              else torch.inference_mode()):
            return fn(*args, **kwargs)

    return run


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


def swiglu_logical_axes() -> dict:
    return {"w_gate": ("d_model", "d_ff"), "w_up": ("d_model", "d_ff"),
            "w_down": ("d_ff", "d_model")}


def flat_axes(prefix: str, tree: Mapping) -> dict:
    """A nested {name: logical axes} tree -> {``prefix`` + dotted name:
    axes}, the port's parameter names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat_axes(f"{prefix}{k}.", v))
        else:
            out[prefix + k] = v
    return out


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
    if isinstance(x, DTensor) and any(p.is_shard(d) for p in x.placements
                                      for d in range(1, x.ndim - 1)):
        # a sequence-parallel input: gathered along its sequence before the
        # column-parallel product (Megatron's all-gather); DTensor cannot
        # flatten two sharded dims into the product's rows
        x = shard(x, "batch", *[None] * (x.ndim - 1))
    rows = x.numel() // x.shape[-1]
    if not x.is_cuda or rows >= min_rows:
        return x @ w
    flat = x.reshape(rows, x.shape[-1])
    out = torch.cat([flat, flat.new_zeros(min_rows - rows, flat.shape[1])]) @ w
    return out[:rows].reshape(*x.shape[:-1], w.shape[-1])


class _WholeSeqGrad(torch.autograd.Function):
    """The identity, whose backward gathers a gradient sharded along a
    middle (sequence) dim: Megatron's sequence parallelism all-gathers the
    gradient ahead of a row-parallel product's backward, whose matmul flattens
    the rows, and DTensor (torch 2.11) cannot flatten two sharded dims."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and any(p.is_shard() and 0 < p.dim < g.ndim - 1
                                          for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_shard() and 0 < p.dim < g.ndim - 1 else p
                for p in g.placements])
        return g


def rows_out(y: torch.Tensor) -> torch.Tensor:
    """``y``, the output of a row-parallel product that the residual stream
    then shards along its sequence (see :class:`_WholeSeqGrad`); the
    identity for a plain tensor."""
    return _WholeSeqGrad.apply(y) if isinstance(y, DTensor) else y


def swiglu_hidden(p: Params, x: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """x: [..., d_model] -> the hidden [..., f] before ``w_down`` (a
    tensor-parallel shard passes its d_ff column slice of the weights);
    ``min_rows`` as in :func:`rows_matmul`."""
    gate = rows_matmul(x, p["w_gate"], min_rows)
    up = rows_matmul(x, p["w_up"], min_rows)
    return F.silu(gate.float()).to(x.dtype) * up


def swiglu_apply(p: Params, x: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model]; d_ff sharded over the model
    axis on a mesh."""
    h = swiglu_hidden(p, x, min_rows)
    # rows stay on their batch block (XLA slices a replicated operand to
    # the output's batch sharding; DTensor would compute every row on
    # every data rank)
    h = shard(h, "batch", *((None,) * (h.ndim - 2)), "d_ff")
    return rows_out(h @ p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table: [vocab, d_model] (vocab-sharded on a mesh); tokens: int [...]
    -> [..., d_model].  A gather; its backward (``embedding_dense_backward``)
    is deterministic, where indexing's accumulating scatter is not on the
    CPU."""
    if isinstance(table, DTensor):
        out = _embed_vocab_sharded(table, tokens)
    else:
        out = F.embedding(tokens.long(), table)
    return shard(out, "batch", *((None,) * (out.ndim - 2)))


def _embed_vocab_sharded(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """The gather over a table whose vocab (dim 0) is sharded over one mesh
    dim: each rank gathers the rows of its own vocab block (zeros for the
    tokens outside it), and the result is a partial sum over that mesh dim,
    exact since all but one term are zeros.  DTensor's own strategy for it
    leaves a masked partial whose backward it cannot always redistribute
    (a partial-sum gradient); this one has none.  A table laid out
    otherwise gathers replicated."""
    mesh = table.device_mesh
    vdims = [i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0]
    if len(vdims) != 1 or any(not isinstance(p, Replicate) for i, p in
                              enumerate(table.placements) if i != vdims[0]):
        table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        return F.embedding(tokens.long(), table)
    vd = vdims[0]
    tok_pl = (tokens.placements if isinstance(tokens, DTensor)
              else (Replicate(),) * mesh.ndim)
    tok = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    # a rank's table gradient sums its own tokens' rows: partial over the
    # mesh dims that shard the tokens
    grad = [Shard(0) if i == vd else (Partial() if isinstance(tok_pl[i], Shard) else Replicate())
            for i in range(mesh.ndim)]
    tl = table.to_local(grad_placements=grad)
    chunk = -(-table.shape[0] // mesh.size(vd))  # torch.chunk's block size
    ids = tok.long() - mesh.get_local_rank(vd) * chunk
    inside = (ids >= 0) & (ids < tl.shape[0])
    out = F.embedding(ids.clamp(0, max(tl.shape[0] - 1, 0)), tl) * inside[..., None].to(tl.dtype)
    pl = [Partial() if i == vd else tok_pl[i] for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, pl, run_check=False)


def logits_last(hidden_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """hidden_last: [B, d] -> float32 logits [B, vocab] (vocab-sharded on
    a mesh)."""
    return shard((hidden_last @ unembed).float(), "batch", "vocab")


# ---------------------------------------------------------------------------
# Training: activation checkpointing and the chunked cross entropy
# ---------------------------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs):
    """``"minimal"``'s rule: keep the 2-D weight products (``aten.mm``) and
    recompute everything else, batched products (``aten.bmm``) included."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@torch.library.custom_op("repro_torch::sp_gathered", mutates_args=())
def _sp_gathered(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` under an op of its own, which ``"sp_save"``'s rule
    saves (the reference's ``checkpoint_name(x, "sp_gathered")``)."""
    return x.clone()


@_sp_gathered.register_fake
def _(x):
    return torch.empty_like(x)


_sp_gathered.register_autograd(lambda ctx, g: g)

_tagging = threading.local()


@contextlib.contextmanager
def _sp_tagging():
    prev = getattr(_tagging, "on", False)
    _tagging.on = True
    try:
        yield
    finally:
        _tagging.on = prev


def tag_sp_gathered(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Tag the post-all-gather q/k/v as saveable under ``"sp_save"``: the
    identity (no copy) outside an ``"sp_save"`` body."""
    if not getattr(_tagging, "on", False):
        return xs

    def tag(x):
        if isinstance(x, DTensor):
            return DTensor.from_local(_sp_gathered(x.to_local()), x.device_mesh, x.placements,
                                      run_check=False)
        return _sp_gathered(x)

    return tuple(tag(x) for x in xs)


def _save_sp_gathered(ctx, op, *args, **kwargs):
    """``"sp_save"``'s rule: keep the tagged tensors, recompute the rest."""
    if op is torch.ops.repro_torch.sp_gathered.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the arch's activation-checkpointing policy, the
    reference's ``maybe_remat``: ``"none"`` stores every activation,
    ``"full"`` recomputes the whole body in the backward pass,
    ``"minimal"`` saves the unbatched weight products only (the
    counterpart of ``dots_with_no_batch_dims_saveable``), and ``"sp_save"``
    is ``"full"`` that saves the tensors tagged by :func:`tag_sp_gathered`
    (the q/k/v projections, which on a sequence-parallel mesh follow the
    sequence all-gathers), with or without a mesh."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if policy in ("minimal", "sp_save"):
        rule = _save_weight_products if policy == "minimal" else _save_sp_gathered

        def contexts():
            return ckpt.create_selective_checkpoint_contexts(rule)

        def body(*a):
            if policy == "minimal":
                return fn(*a)
            with _sp_tagging():
                return fn(*a)

        return lambda *a: ckpt.checkpoint(body, *a, use_reentrant=False,
                                          context_fn=contexts)
    raise ValueError(f"unknown remat_policy {policy!r}")


def _chunk_xent(h: torch.Tensor, unembed: torch.Tensor, t: torch.Tensor,
                m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = shard((h @ unembed).float(), "batch", None, "vocab")  # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logits gathered from this rank's batch block with the vocab
    # whole: DTensor's gather may shard the vocab and leave a masked partial
    # that its later ops cannot reduce
    if isinstance(logits, DTensor):
        ll, tl = local(logits, "batch", None, None), local(t, "batch", None)
        gold = from_local(ll.gather(-1, tl.long()[..., None])[..., 0], "batch", None)
    else:
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
