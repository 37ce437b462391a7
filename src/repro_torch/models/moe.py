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
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import MoEConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp_params, param, swiglu_apply


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


def _capacity(T: int, moe: MoEConfig) -> int:
    return max(int(math.ceil(T * moe.top_k * moe.capacity_factor / moe.num_experts)), 1)


def _route(p, x: torch.Tensor, moe: MoEConfig):
    """x: [B, T, d] -> (gate weights [B, T, k] in x's dtype, expert ids
    [B, T, k] in descending logit order, GShard aux loss)."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(logits, moe.top_k, dim=-1, sorted=True)
    weights = torch.softmax(gates, dim=-1).to(x.dtype)
    E = moe.num_experts
    frac = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
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
    xe = buf.permute(1, 0, 2, 3).reshape(E, B * C, d)
    gate = torch.bmm(xe, p.w_gate)
    up = torch.bmm(xe, p.w_up)
    h = F.silu(gate.float()).to(buf.dtype) * up
    out = torch.bmm(h, p.w_down)
    return out.reshape(E, B, C, d).permute(1, 0, 2, 3)


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
    weights, idx, aux = _route(p, x, moe)
    eid, pos, keep = _slot_positions(idx, moe, C)
    rows = torch.arange(B, device=x.device)[:, None].expand_as(eid)
    tok = (torch.arange(T * k, device=x.device) // k)[None, :].expand_as(eid)
    buf = x.new_zeros((B, moe.num_experts, C, d))
    buf[rows[keep], eid[keep], pos[keep]] = x[rows[keep], tok[keep]]
    out = _expert_ffn(p, buf)
    y_slots = out[rows, eid, torch.where(keep, pos, 0)] * keep[..., None].to(x.dtype)
    return _combine(y_slots, weights), aux


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
