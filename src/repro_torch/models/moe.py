"""Mixture-of-experts FFN (DeepSeek-MoE fine-grained / Llama-4 top-1), the
port of the JAX package's ``models/moe.py``.

* :func:`moe_apply_scatter` (the default): capacity dispatch per batch row.
  A one-hot cumsum in slot order (token-major, then k) gives each (token,
  slot) its position in its expert's buffer ``[B, E, C, d]``; slots past the
  capacity ``C`` are dropped (they add nothing: the residual stream passes
  unchanged); the experts run as batched matmuls over ``[E, B*C, d]``; each
  slot's output is gathered back and the k slots of a token are summed,
  weighted by their gates, in slot order.
* :func:`moe_apply_dense` (GShard's one-hot einsum): the oracle for small
  shapes.

In the reference every dropped slot adds an exact zero at position 0 of its
expert and every kept (row, expert, position) is unique, so the scatter here
assigns only the kept slots (``index_put_`` without ``accumulate``): the
same buffer, and no atomics on the card.  The router runs in float32 (its
weight is float32 even in a bf16 model) and the gates are cast to the
activation dtype, as in the reference.

On a mesh (:mod:`repro_torch.distributed.sharding`) the experts run as
DTensor products sharded over the experts; the routing and the dispatch
and combine (data-dependent indexing, which DTensor cannot shard) run on
each rank's batch block as local tensors, since the capacity group is the
batch row, and the load-balance loss takes its means over the global
batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.config import MoEConfig
from repro_torch.distributed.sharding import batch_sum, current_context, from_local, local, shard
from repro_torch.models.layers import (
    dense_init,
    init_mlp,
    mlp_params,
    param,
    swiglu_apply,
    swiglu_logical_axes,
)


class MoE(nn.Module):
    """The reference's ``moe_params`` leaves: ``router [d, E]`` (float32),
    ``w_gate``/``w_up [E, d, ff]``, ``w_down [E, ff, d]`` and, with shared
    experts, ``shared`` (one SwiGLU of width ``shared_d_ff *
    num_shared_experts``)."""

    def __init__(self, d_model: int, moe: MoEConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = moe
        E, ff = moe.num_experts, moe.expert_d_ff
        self.router = param((d_model, E), torch.float32, device)
        self.w_gate = param((E, d_model, ff), dtype, device)
        self.w_up = param((E, d_model, ff), dtype, device)
        self.w_down = param((E, ff, d_model), dtype, device)
        if moe.num_shared_experts:
            self.shared = mlp_params(d_model, moe.shared_d_ff * moe.num_shared_experts,
                                     dtype, device)

    def init(self, g: torch.Generator) -> None:
        """The reference's distributions: N(0, 1/fan_in), fan_in = d for the
        router and the up projections, ff for ``w_down``."""
        d, ff = self.w_gate.shape[1], self.w_gate.shape[2]
        for name, fan_in in (("router", d), ("w_gate", d), ("w_up", d), ("w_down", ff)):
            w = getattr(self, name)
            w.data.copy_(dense_init(g, w.shape, fan_in, w.dtype, w.device))
        if self.cfg.num_shared_experts:
            init_mlp(self.shared, g)


def moe_logical_axes(moe: MoEConfig) -> dict:
    ax = {"router": (None, None),
          "w_gate": ("experts", None, "expert_ff"),
          "w_up": ("experts", None, "expert_ff"),
          "w_down": ("experts", "expert_ff", None)}
    if moe.num_shared_experts:
        ax["shared"] = swiglu_logical_axes()
    return ax


def _capacity(T: int, moe: MoEConfig) -> int:
    return max(int(math.ceil(T * moe.top_k * moe.capacity_factor / moe.num_experts)), 1)


def _route(p, x: torch.Tensor, moe: MoEConfig, n_tokens: int = 0):
    """x: [B, T, d] -> (gate weights [B, T, k] in x's dtype, expert ids
    [B, T, k] in descending logit order, GShard aux loss).  With
    ``n_tokens`` (the global batch's tokens), x is one rank's batch block
    and the aux loss's means are taken over the global batch."""
    logits = x.float() @ local(p.router, None, None).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(logits, moe.top_k, dim=-1, sorted=True)
    weights = torch.softmax(gates, dim=-1).to(x.dtype)
    E = moe.num_experts
    top1 = F.one_hot(idx[..., 0], E).float()
    if n_tokens:
        frac = batch_sum(top1.sum(dim=(0, 1))) / n_tokens
        aux = E * torch.sum(frac * (batch_sum(probs.sum(dim=(0, 1))) / n_tokens))
    else:
        aux = E * torch.sum(top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    return weights, idx, aux


def _slot_positions(idx: torch.Tensor, moe: MoEConfig, C: int):
    """Per batch row, each slot's position in its expert's buffer (slots in
    token-major, then k, order) and whether it fits the capacity ``C``.
    Returns (expert ids [B, T*k], positions [B, T*k], keep [B, T*k])."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1)
    onehot = F.one_hot(flat, moe.num_experts)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, flat[..., None])[..., 0]
    return flat, pos, pos < C


def _expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """buf: [B, E, C, d] -> [B, E, C, d] through each expert's SwiGLU, as
    batched matmuls over [E, B*C, d]."""
    B, E, C, d = buf.shape
    ctx = current_context()
    # with expert_ff sharded the batch is released inside the experts (the
    # reference's 2-D expert sharding)
    bspec = None if ctx is not None and ctx.rules.get("expert_ff") is not None else "batch"
    buf = shard(buf, bspec, "experts", None, None)
    xe = buf.permute(1, 0, 2, 3).reshape(E, B * C, d)
    gate = torch.bmm(xe, p.w_gate)
    up = torch.bmm(xe, p.w_up)
    h = F.silu(gate.float()).to(buf.dtype) * up
    h = shard(h, "experts", bspec, "expert_ff")
    out = torch.bmm(h, p.w_down)
    return shard(out.reshape(E, B, C, d).permute(1, 0, 2, 3), "batch", "experts", None, None)


def _combine(y_slots: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[B, T*k, d] slot outputs -> [B, T, d], the k slots of each token
    weighted and summed in slot order."""
    B, T, k = weights.shape
    ys = y_slots.reshape(B, T, k, -1) * weights[..., None]
    y = ys[:, :, 0]
    for j in range(1, k):
        y = y + ys[:, :, j]
    return y


def moe_apply_scatter(p, x: torch.Tensor, moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y [B, T, d], aux loss).  The capacity group is the
    batch row."""
    B, T, d = x.shape
    k = moe.top_k
    C = _capacity(T, moe)
    sharded = isinstance(x, DTensor)
    xl = local(x, "batch", None, None)  # this rank's batch block
    weights, idx, aux = _route(p, xl, moe, B * T if sharded else 0)
    eid, pos, keep = _slot_positions(idx, moe, C)
    rows = torch.arange(xl.shape[0], device=x.device)[:, None].expand_as(eid)
    tok = (torch.arange(T * k, device=x.device) // k)[None, :].expand_as(eid)
    # a dropped token writes to a spare slot C that the experts never see:
    # no mask selects the tokens, so no shape depends on the routing
    buf = xl.new_zeros((xl.shape[0], moe.num_experts, C + 1, d))
    buf[rows, eid, torch.where(keep, pos, C)] = xl[rows, tok]
    buf = buf[:, :, :C].contiguous()
    out = local(_expert_ffn(p, from_local(buf, "batch", None, None, None)),
                "batch", None, None, None)
    y_slots = out[rows, eid, torch.where(keep, pos, 0)] * keep[..., None].to(x.dtype)
    return from_local(_combine(y_slots, weights), "batch", None, None), aux


def moe_apply_dense(p, x: torch.Tensor, moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard's one-hot einsum dispatch: the oracle (small shapes only)."""
    B, T, d = x.shape
    k, E = moe.top_k, moe.num_experts
    C = _capacity(T, moe)
    weights, idx, aux = _route(p, x, moe)
    eid, pos, keep = _slot_positions(idx, moe, C)
    disp = (F.one_hot(eid, E).to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, C), C + 1).to(x.dtype)[..., None, :C])
    x_rep = x[:, torch.arange(T * k, device=x.device) // k]
    buf = torch.einsum("bsec,bsd->becd", disp, x_rep)
    y_slots = torch.einsum("bsec,becd->bsd", disp, _expert_ffn(p, buf))
    return _combine(y_slots, weights), aux


def moe_apply(p, x: torch.Tensor, moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts (``moe.dispatch``) plus the shared ones."""
    if moe.dispatch == "dense":
        y, aux = moe_apply_dense(p, x, moe)
    else:
        y, aux = moe_apply_scatter(p, x, moe)
    if moe.num_shared_experts:
        y = y + swiglu_apply(p.shared, x)
    return y, aux
