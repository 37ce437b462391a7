"""Zamba2 hybrid (arXiv:2411.15242) for the hybrid family (zamba2-7b): a
Mamba2 trunk plus one *shared* full-attention transformer block applied
every ``shared_attn_every`` Mamba blocks, fed with concat(hidden, original
embedding).

81 blocks = 13 groups of (shared attention + 6 Mamba2) + a tail of (shared
attention + 3 Mamba2): 14 shared-attention applications, each with its own
KV cache.  Decode writes the shared attention's K/V into a ring buffer at
``lens % capacity`` (RoPE applied at write time with absolute positions, so
the rotated slot order is harmless).

Parameters keep the JAX package's names and layouts; the Mamba2 blocks are
one ``nn.ModuleList`` (``mamba.{i}``, groups first, then the tail) instead
of the reference's ``mamba_groups`` [G, per_group, ...] and ``mamba_tail``
[tail, ...] stacks, which :mod:`repro_torch.models.bridge` unstacks.  The
cache is the reference's dict (``ssm`` [L, B, H, N, P] f32, ``conv``
[L, B, conv_dim, K-1] f32, ``k``/``v`` [A, B, capacity, KV, hd], ``lens``).
The training loss (:meth:`Zamba2LM.loss`) runs the plain SSD scan and
attention, which autograd differentiates.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import reduce_partials, shard
from repro_torch.models import attention as attn_lib
from repro_torch.models.api import token_specs
from repro_torch.models.layers import (
    commit_rows,
    dense_init,
    embed_init,
    embed_lookup,
    flat_axes,
    init_mlp,
    logits_last,
    maybe_remat,
    mlp_params,
    param,
    rms_norm,
    serving,
    softmax_xent,
    swiglu_apply,
    swiglu_logical_axes,
    zeros_cache,
)
from repro_torch.models.mamba2 import Mamba2Block
from repro_torch.models.transformer import (
    attn_full,
    attn_logical_axes,
    attn_params,
    init_attn,
    out_proj,
    project_qkv,
)

Cache = Dict[str, torch.Tensor]


class SharedBlock(nn.Module):
    """The shared attention block: RMSNorm(concat(x, x0)) → ``w_in`` →
    attention → SwiGLU → ``w_out``, added to the residual stream."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, f32 = cfg.d_model, torch.float32
        self.ln_in = param((2 * d,), f32, device)
        self.w_in = param((2 * d, d), dtype, device)
        self.ln1 = param((d,), f32, device)
        self.attn = attn_params(cfg, dtype, device)
        self.ln2 = param((d,), f32, device)
        self.mlp = mlp_params(d, cfg.d_ff, dtype, device)
        self.w_out = param((d, d), dtype, device)

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        d = cfg.d_model
        for n in ("ln_in", "ln1", "ln2"):
            getattr(self, n).data.fill_(1.0)
        self.w_in.data.copy_(dense_init(g, self.w_in.shape, 2 * d, self.w_in.dtype,
                                        self.w_in.device))
        init_attn(self.attn, cfg, g)
        init_mlp(self.mlp, g)
        self.w_out.data.copy_(dense_init(g, self.w_out.shape, d, self.w_out.dtype,
                                         self.w_out.device))

    def _enter(self, cfg: ArchConfig, x, x0):
        xin = rms_norm(torch.cat([x, x0], dim=-1), self.ln_in, cfg.rms_eps) @ self.w_in
        return xin, rms_norm(xin, self.ln1, cfg.rms_eps)

    def _leave(self, cfg: ArchConfig, x, xin):
        xin = xin + swiglu_apply(self.mlp, rms_norm(xin, self.ln2, cfg.rms_eps))
        return x + xin @ self.w_out

    def seq(self, cfg: ArchConfig, x, x0, *, window: int = 0, impl: str = "kernel"):
        """x, x0: [B, T, d] -> (x, roped k, v [B, T, KV, hd])."""
        xin, h1 = self._enter(cfg, x, x0)
        o, k, v = attn_full(self.attn, cfg, h1, causal=True, window=window, impl=impl)
        return self._leave(cfg, x, xin + o), k, v

    def step(self, cfg: ArchConfig, x, x0, kc, vc, lens, rows=None):
        """One decode token per row; ring-buffer K/V write at
        ``lens % capacity`` into ``kc``/``vc`` [B, capacity, KV, hd] in
        place, for ``rows`` only when given."""
        capacity = kc.shape[1]
        xin, h1 = self._enter(cfg, x, x0)
        q, k, v = project_qkv(self.attn, cfg, h1[:, None, :], lens[:, None])
        attn_lib.write_kv(kc, vc, k[:, 0], v[:, 0], lens % capacity, rows=rows)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, torch.clamp(lens + 1, max=capacity))
        return self._leave(cfg, x, xin + out_proj(self.attn, o))


class Zamba2LM(nn.Module):
    """Zamba2 language model.  Weights are allocated uninitialised: call
    :meth:`init` (random, from a ``torch.Generator``) or load them."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.ssm is None or cfg.ssm.kind != "mamba2" or cfg.shared_attn_every <= 0:
            raise ValueError(f"{cfg.name}: Zamba2LM needs a mamba2 ssm config with "
                             "shared attention")
        self.cfg = cfg
        every = cfg.shared_attn_every
        self.n_groups = cfg.num_layers // every
        self.tail = cfg.num_layers - self.n_groups * every
        self.per_group = every
        # one shared-attn application per group (+ one before the tail if any)
        self.n_attn_apps = self.n_groups + (1 if self.tail else 0)
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = param((V, d), dtype, dev)
        self.final_norm = param((d,), torch.float32, dev)
        self.unembed = param((d, V), dtype, dev)
        self.shared = SharedBlock(cfg, dtype, dev)
        self.mamba = nn.ModuleList(Mamba2Block(cfg, dtype, dev)
                                   for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)

    def init(self, generator: torch.Generator) -> "Zamba2LM":
        """Random weights with the reference's distributions."""
        self.embed.data.copy_(embed_init(generator, self.embed.shape, self.embed.dtype,
                                         self.device))
        self.unembed.data.copy_(embed_init(generator, self.unembed.shape,
                                           self.unembed.dtype, self.device))
        self.final_norm.data.fill_(1.0)
        self.shared.init(self.cfg, generator)
        for blk in self.mamba:
            blk.init(generator)
        return self

    def param_logical_axes(self) -> Dict[str, Tuple]:
        """{parameter name: logical axes}, the reference's axes (its stacked
        Mamba leaves' leading group and layer axes dropped)."""
        cfg = self.cfg
        shared = {"ln_in": (None,), "w_in": (None, None), "ln1": (None,),
                  "attn": attn_logical_axes(cfg), "ln2": (None,),
                  "mlp": swiglu_logical_axes(), "w_out": (None, None)}
        ax = {"embed": ("vocab", None), "final_norm": (None,), "unembed": (None, "vocab")}
        ax.update(flat_axes("shared.", shared))
        for i in range(len(self.mamba)):
            ax.update(flat_axes(f"mamba.{i}.", Mamba2Block.LOGICAL_AXES))
        return ax

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """{name: (shape, dtype name, logical axes)} of a dry-run cell's
        inputs (the token inputs)."""
        return token_specs(shape)

    # -- caches -------------------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        w = self.cfg.long_context_window
        return min(seq_len, w) if w else seq_len

    def cache_shape(self, batch: int, capacity: int):
        """{name: (shape, dtype name, logical axes)}, as the reference's."""
        cfg = self.cfg
        m = self.mamba[0]
        L, A = cfg.num_layers, self.n_attn_apps
        kv = ((A, batch, capacity, cfg.num_kv_heads, cfg.head_dim), cfg.activation_dtype,
              ("layers", "batch", "kv_seq", "kv_heads", None))
        return {
            "ssm": ((L, batch, m.H, m.N, m.P), "float32",
                    ("layers", "batch", "heads", None, None)),
            "conv": ((L, batch, m.conv_dim, m.K - 1), "float32",
                     ("layers", "batch", None, None)),
            "k": kv,
            "v": kv,
            "lens": ((batch,), "int32", ("batch",)),
        }

    def init_cache(self, batch: int, capacity: int) -> Cache:
        return zeros_cache(self.cache_shape(batch, capacity), self.device)

    def _schedule(self):
        """(attention application, Mamba2 block indices after it), in order:
        one per group, then the tail's."""
        G, r = self.n_groups, self.per_group
        apps = [(g, range(g * r, (g + 1) * r)) for g in range(G)]
        if self.tail:
            apps.append((G, range(G * r, self.cfg.num_layers)))
        return apps

    # -- train -------------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]):
        """The reference's training loss (``tokens``, ``targets``,
        ``loss_mask``): the shared attention (plain, causal) before each
        group, every Mamba2 block from a zero state through the plain SSD
        scan and checkpointed under ``remat_policy``, as the reference's
        ``mamba_chain``; then the chunked cross entropy.  Returns (xent,
        {"xent", "aux": 0})."""
        cfg, dev = self.cfg, self.device
        B = batch["tokens"].shape[0]
        x = shard(embed_lookup(self.embed, batch["tokens"].to(dev)).to(self.act_dtype),
                  "batch", None, None)
        x0 = x
        for _, blocks in self._schedule():
            x, _, _ = self.shared.seq(cfg, x, x0, impl="plain")
            for i in blocks:
                m = self.mamba[i]
                state = zeros_cache(m.state_shape(B), dev)
                x = maybe_remat(lambda x, m=m, st=state: m.apply_seq(x, st, impl="plain")[0],
                                cfg.remat_policy)(x)
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        xent, _ = softmax_xent(x, self.unembed, batch["targets"].to(dev),
                               batch["loss_mask"].to(dev))
        return xent, {"xent": xent, "aux": xent.new_zeros(())}

    # -- serve -------------------------------------------------------------------
    @serving
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] -> (next-token logits [B, V] f32, cache).  The
        shared attention's K/V is written at [0, S) and zero-padded to
        ``capacity`` (or cut to it when S > capacity, as the reference does;
        the engine keeps S <= capacity).  ``impl`` picks the kernels or
        their plain versions for the SSD scans and the shared attention
        alike: see the module docstring of :mod:`repro_torch.models.mamba2`
        and :func:`repro_torch.models.attention.prefill_attention`.  The
        shared attention is causal over the whole prompt, as the reference's
        prefill (its sliding window applies to long-context decode only)."""
        cfg = self.cfg
        B, S = tokens.shape
        capacity = capacity or self.cache_capacity(S)
        x = shard(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                  "batch", None, None)
        x0 = x
        ssm, conv, ks, vs = [], [], [], []
        for _, blocks in self._schedule():
            x, k, v = self.shared.seq(cfg, x, x0, impl=impl)
            ks.append(k)
            vs.append(v)
            for i in blocks:
                m = self.mamba[i]
                x, ns = m.apply_seq(x, zeros_cache(m.state_shape(B), self.device), impl=impl)
                ssm.append(ns["ssm"])
                conv.append(ns["conv"])
        k_all, v_all = torch.stack(ks), torch.stack(vs)  # [A, B, S, KV, hd]
        if capacity > S:
            pad = (0, 0, 0, 0, 0, capacity - S)
            k_all = torch.nn.functional.pad(k_all, pad)
            v_all = torch.nn.functional.pad(v_all, pad)
        else:
            k_all, v_all = k_all[:, :, :capacity], v_all[:, :, :capacity]
        cache = {"ssm": torch.stack(ssm), "conv": torch.stack(conv), "k": k_all, "v": v_all,
                 "lens": torch.full((B,), S, dtype=torch.int32, device=self.device)}
        logits = logits_last(rms_norm(x[:, -1], self.final_norm, cfg.rms_eps), self.unembed)
        return logits, cache

    @serving
    def decode(self, tokens: torch.Tensor, cache: Cache,
               active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B] -> (logits [B, V] f32, cache).  Updates the state and
        K/V leaves in place (the reference returns a new cache; the port
        saves the copy).  ``active`` [B] bool marks the rows whose cache the
        step advances (all when None); the other rows are computed, and
        their cache and ``lens`` are left as they were."""
        cfg = self.cfg
        cache = reduce_partials(cache)
        lens = cache["lens"]
        rows = None if active is None else active.nonzero()[:, 0]
        x = shard(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                  "batch", None)
        x0 = x
        for a, blocks in self._schedule():
            x = self.shared.step(cfg, x, x0, cache["k"][a], cache["v"][a], lens, rows)
            for i in blocks:
                x, ns = self.mamba[i].apply_step(x, {"ssm": cache["ssm"][i],
                                                     "conv": cache["conv"][i]})
                commit_rows(cache["ssm"][i], ns["ssm"], active)
                commit_rows(cache["conv"][i], ns["conv"], active)
        logits = logits_last(rms_norm(x, self.final_norm, cfg.rms_eps), self.unembed)
        step = 1 if active is None else active.to(lens.dtype)
        return logits, {**cache, "lens": lens + step}
