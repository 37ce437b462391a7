"""RWKV6 "Finch" (arXiv:2404.05892) — attention-free LM with data-dependent
per-channel decay, for the ssm family (rwkv6-7b).

Decode state is O(1) in sequence length, so NEO's KV offloading does not
apply: the engine serves these requests device-only through its contiguous
slot executor.  Parameters keep the JAX package's names and layouts
(``wr [d, H, N]``, ``wo [H, N, d]``, ``wck [d, f]``); the layers are an
``nn.ModuleList`` instead of the reference's ``vmap``-stacked ``blocks``, so
:mod:`repro_torch.models.bridge` unstacks them.  The cache is the
reference's dict (``state`` [L, B, H, N, N] f32, ``tm_prev`` / ``cm_prev``
[L, B, d], ``lens`` [B]).

Every prefill runs the chunked scan once per layer: ``impl="kernel"`` (the
default) calls :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan`, which
launches the CUDA kernel for tensors on the card and takes the plain version
for tensors on the CPU; ``impl="plain"`` calls the plain version on either,
as the card's parity oracle does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked
from repro_torch.models.layers import (
    commit_rows,
    dense_init,
    embed_init,
    embed_lookup,
    group_norm_heads,
    logits_last,
    param,
    rms_norm,
    zeros_cache,
)

Cache = Dict[str, torch.Tensor]

MAA_RANK = 32
DECAY_RANK = 64
IMPLS = ("kernel", "plain")


def scan(impl: str):
    """The chunked scan for ``impl``: the wrapper (kernel on the card, plain
    version on the CPU) or the plain version."""
    if impl == "kernel":
        return scan_ops.rwkv6_scan
    if impl == "plain":
        return lambda *a: rwkv6_chunked(*a, chunk=scan_ops.CHUNK)
    raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


class RWKV6Block(nn.Module):
    """One layer: time-mix (the recurrence) then channel-mix."""

    def __init__(self, cfg: ArchConfig, H: int, N: int, maa_rank: int, decay_rank: int,
                 dtype: torch.dtype, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        f32 = torch.float32
        shapes = {
            "ln1": ((d,), f32), "ln2": ((d,), f32),
            "mu_x": ((d,), f32), "mu_5": ((5, d), f32),
            "maa_w1": ((d, 5 * maa_rank), f32), "maa_w2": ((5, maa_rank, d), f32),
            "w0": ((d,), f32), "decay_w1": ((d, decay_rank), f32),
            "decay_w2": ((decay_rank, d), f32), "u": ((H, N), f32),
            "wr": ((d, H, N), dtype), "wk": ((d, H, N), dtype), "wv": ((d, H, N), dtype),
            "wg": ((d, H, N), dtype), "wo": ((H, N, d), dtype),
            "ln_x_scale": ((H, N), f32), "ln_x_bias": ((H, N), f32),
            "mu_ck": ((d,), f32), "mu_cr": ((d,), f32),
            "wck": ((d, ff), dtype), "wcv": ((ff, d), dtype), "wcr": ((d, d), dtype),
        }
        for name, (shape, dt) in shapes.items():
            setattr(self, name, param(shape, dt, device))
        self.maa_rank = maa_rank

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        """The reference's distributions (``rwkv6.py::_layer_params``)."""
        d, ff = cfg.d_model, cfg.d_ff
        for name in ("ln1", "ln2", "ln_x_scale"):
            getattr(self, name).data.fill_(1.0)
        for name in ("mu_x", "mu_5", "u", "ln_x_bias", "mu_ck", "mu_cr"):
            getattr(self, name).data.zero_()
        self.w0.data.fill_(-0.6)
        fan_in = {"maa_w1": d, "maa_w2": self.maa_rank, "decay_w1": d,
                  "decay_w2": self.decay_w2.shape[0], "wr": d, "wk": d, "wv": d,
                  "wg": d, "wo": d, "wck": d, "wcv": ff, "wcr": d}
        for name, fi in fan_in.items():
            p = getattr(self, name)
            p.data.copy_(dense_init(g, p.shape, fi, p.dtype, p.device))


class RWKV6LM(nn.Module):
    """RWKV6 language model.  Weights are allocated uninitialised: call
    :meth:`init` (random, from a ``torch.Generator``) or load them."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
            raise ValueError(f"{cfg.name}: RWKV6LM needs an rwkv6 ssm config")
        self.cfg = cfg
        self.H = cfg.num_heads
        self.N = cfg.ssm.head_dim
        if self.H * self.N != cfg.d_model:
            raise ValueError(f"heads {self.H} x head size {self.N} != d_model {cfg.d_model}")
        self.maa_rank = min(MAA_RANK, cfg.d_model // 4)
        self.decay_rank = min(DECAY_RANK, cfg.d_model // 4)
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = param((V, d), dtype, dev)
        self.ln0 = param((d,), torch.float32, dev)
        self.final_norm = param((d,), torch.float32, dev)
        self.unembed = param((d, V), dtype, dev)
        self.blocks = nn.ModuleList(
            RWKV6Block(cfg, self.H, self.N, self.maa_rank, self.decay_rank, dtype, dev)
            for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)

    def init(self, generator: torch.Generator) -> "RWKV6LM":
        """Random weights with the reference's distributions."""
        self.embed.data.copy_(embed_init(generator, self.embed.shape, self.embed.dtype,
                                         self.device))
        self.unembed.data.copy_(embed_init(generator, self.unembed.shape,
                                           self.unembed.dtype, self.device))
        self.ln0.data.fill_(1.0)
        self.final_norm.data.fill_(1.0)
        for blk in self.blocks:
            blk.init(self.cfg, generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- caches --------------------------------------------------------------
    def cache_shape(self, batch: int, capacity: int):
        """{name: (shape, dtype name, logical axes)}, as the reference's."""
        cfg = self.cfg
        L, H, N, d = cfg.num_layers, self.H, self.N, cfg.d_model
        return {
            "state": ((L, batch, H, N, N), "float32", ("layers", "batch", "heads", None, None)),
            "tm_prev": ((L, batch, d), cfg.activation_dtype, ("layers", "batch", None)),
            "cm_prev": ((L, batch, d), cfg.activation_dtype, ("layers", "batch", None)),
            "lens": ((batch,), "int32", ("batch",)),
        }

    def init_cache(self, batch: int, capacity: int) -> Cache:
        return zeros_cache(self.cache_shape(batch, capacity), self.device)

    # -- block pieces ----------------------------------------------------------
    def _ddlerp(self, p: RWKV6Block, x, sx):
        """Data-dependent lerp producing the 5 mixed inputs (w, k, v, r, g)."""
        xxx = x + sx * p.mu_x.to(x.dtype)
        r1 = torch.tanh(xxx.float() @ p.maa_w1)
        r1 = r1.reshape(*r1.shape[:-1], 5, self.maa_rank)
        deltas = torch.einsum("...fr,frd->...fd", r1, p.maa_w2)  # [..., 5, d]
        return [x + sx * (p.mu_5[i] + deltas[..., i, :]).to(x.dtype) for i in range(5)]

    @staticmethod
    def _decay(p: RWKV6Block, xw):
        ww = p.w0 + (xw.float() @ p.decay_w1) @ p.decay_w2
        return torch.exp(-torch.exp(ww))  # (0, 1), per channel

    def _heads(self, x, w):
        """x [..., d] @ w [d, H, N] -> [..., H, N]."""
        return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], self.H, self.N)

    def _out(self, y, wo):
        """y [..., H, N] @ wo [H, N, d] -> [..., d]."""
        return y.reshape(*y.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])

    def _time_mix_seq(self, p: RWKV6Block, x, state0, x_prev0, impl: str):
        """x: [B, T, d]; returns (out [B, T, d], final state, last x)."""
        prev = torch.cat([x_prev0[:, None, :], x[:, :-1]], dim=1)
        sx = prev - x
        xw, xk, xv, xr, xg = self._ddlerp(p, x, sx)
        r, k, v = self._heads(xr, p.wr), self._heads(xk, p.wk), self._heads(xv, p.wv)
        g = F.silu(self._heads(xg, p.wg).float()).to(x.dtype)
        w = self._decay(p, xw).reshape(*x.shape[:2], self.H, self.N)
        y, sT = scan(impl)(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                           p.u, state0.contiguous())
        y = group_norm_heads(y, p.ln_x_scale, p.ln_x_bias)
        return self._out(y * g, p.wo), sT, x[:, -1]

    def _time_mix_step(self, p: RWKV6Block, x, state, x_prev):
        """x: [B, d], one token."""
        sx = x_prev - x
        xw, xk, xv, xr, xg = self._ddlerp(p, x, sx)
        r, k, v = self._heads(xr, p.wr), self._heads(xk, p.wk), self._heads(xv, p.wv)
        g = F.silu(self._heads(xg, p.wg).float()).to(x.dtype)
        w = self._decay(p, xw).reshape(x.shape[0], self.H, self.N)
        y, state = scan_ops.rwkv6_decode_step(r, k, v, w, p.u, state)
        y = group_norm_heads(y, p.ln_x_scale, p.ln_x_bias)
        return self._out(y * g, p.wo), state, x

    @staticmethod
    def _channel_mix(p: RWKV6Block, x, sx):
        xk = x + sx * p.mu_ck.to(x.dtype)
        xr = x + sx * p.mu_cr.to(x.dtype)
        k = torch.square(torch.relu((xk @ p.wck).float())).to(x.dtype)
        kv = k @ p.wcv
        rgate = torch.sigmoid((xr @ p.wcr).float())
        return (rgate * kv.float()).to(x.dtype)

    def _channel_mix_seq(self, p: RWKV6Block, x, x_prev0):
        prev = torch.cat([x_prev0[:, None, :], x[:, :-1]], dim=1)
        return self._channel_mix(p, x, prev - x), x[:, -1]

    # -- full-sequence forward ---------------------------------------------------
    def _forward_seq(self, tokens: torch.Tensor, state: Optional[Cache] = None,
                     impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """Returns (hidden [B, T, d], new state)."""
        cfg = self.cfg
        B, T = tokens.shape
        x = rms_norm(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                     self.ln0, cfg.rms_eps)
        if state is None:
            state = self.init_cache(B, 0)
        states, tms, cms = [], [], []
        for i, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            o, sT, tm_last = self._time_mix_seq(blk, h, state["state"][i],
                                                state["tm_prev"][i], impl)
            x = x + o
            h2 = rms_norm(x, blk.ln2, cfg.rms_eps)
            m, cm_last = self._channel_mix_seq(blk, h2, state["cm_prev"][i])
            x = x + m
            states.append(sT)
            tms.append(tm_last)
            cms.append(cm_last)
        new_state = {"state": torch.stack(states), "tm_prev": torch.stack(tms),
                     "cm_prev": torch.stack(cms), "lens": state["lens"] + T}
        return x, new_state

    # -- serve -------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] -> (next-token logits [B, V] f32, state).
        ``capacity`` is accepted for the executor's uniform call and unused:
        the state does not grow with the sequence."""
        x, state = self._forward_seq(tokens, impl=impl)
        logits = logits_last(rms_norm(x[:, -1], self.final_norm, self.cfg.rms_eps),
                             self.unembed)
        return logits, state

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B] -> (logits [B, V] f32, cache).  Updates the state
        leaves in place (the reference returns a new cache; the port saves
        the copy).  ``active`` [B] bool marks the rows whose state the step
        advances (all when None); the other rows are computed, and their
        state and ``lens`` are left as they were."""
        cfg = self.cfg
        x = rms_norm(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                     self.ln0, cfg.rms_eps)
        for i, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            o, sT, tm_last = self._time_mix_step(blk, h, cache["state"][i],
                                                 cache["tm_prev"][i])
            x = x + o
            h2 = rms_norm(x, blk.ln2, cfg.rms_eps)
            m = self._channel_mix(blk, h2, cache["cm_prev"][i] - h2)
            x = x + m
            commit_rows(cache["state"][i], sT, active)
            commit_rows(cache["tm_prev"][i], tm_last, active)
            commit_rows(cache["cm_prev"][i], h2, active)
        logits = logits_last(rms_norm(x, self.final_norm, cfg.rms_eps), self.unembed)
        step = 1 if active is None else active.to(cache["lens"].dtype)
        return logits, {**cache, "lens": cache["lens"] + step}

