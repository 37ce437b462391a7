"""Decoder-only LM for the dense family (qwen3-*, yi-9b, the paper's
LLaMa models).

Parameters live in an ``nn.Module`` tree whose leaves keep the JAX
package's layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, ``w_gate [d, f]``)
so :mod:`repro_torch.models.bridge` maps one onto the other leaf for leaf.
Layers are an ``nn.ModuleList`` instead of the reference's ``vmap``-stacked
groups; the serve entry points are :meth:`DenseLM.prefill` (cold prefill,
per-layer K/V out), :meth:`DenseLM.decode` (one token over a contiguous
cache — the dense oracle the paged engine is held to) and, for prefix-cache
hits, :meth:`DenseLM.prefill_with_prefix` (the suffix over a cached prefix
gathered from the device pool) and :meth:`DenseLM.prefill_with_host_prefix`
(the suffix over a prefix the host serves in place, through a per-layer
callback).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    logits_last,
    param,
    rms_norm,
    swiglu_apply,
)

Cache = Dict[str, torch.Tensor]


def project_qkv(p, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor):
    """h: [B, S, d]; positions: [B, S] or [S].  Returns roped q [B,S,H,hd],
    k and v [B,S,KV,hd]."""
    B, S, d = h.shape
    q = (h @ p["wq"].reshape(d, -1)).view(B, S, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"].reshape(d, -1)).view(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].reshape(d, -1)).view(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if positions.ndim == 1:
        positions = positions[None, :]
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def out_proj(p, o: torch.Tensor) -> torch.Tensor:
    """o: [..., H, hd] -> [..., d] through ``wo [H, hd, d]``."""
    H, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, d)


def attn_full(p, cfg: ArchConfig, x: torch.Tensor, *, causal: bool = True,
              window: int = 0, impl: str = "kernel"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill); x: [B, S, d] normalised input.
    Returns (out [B, S, d], roped k [B, S, KV, hd], v [B, S, KV, hd]).
    ``impl``: see :func:`repro_torch.models.attention.prefill_attention`."""
    S = x.shape[1]
    q, k, v = project_qkv(p, cfg, x, torch.arange(S, device=x.device))
    o = attn_lib.prefill_attention(q, k, v, causal=causal, window=window, impl=impl)
    return out_proj(p, o), k, v


def attn_params(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    """``wq [d, H, hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H, hd, d]`` and,
    with ``qk_norm``, the q/k norm scales (uninitialised)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": param((d, H, hd), dtype, device),
            "wk": param((d, KV, hd), dtype, device),
            "wv": param((d, KV, hd), dtype, device),
            "wo": param((H, hd, d), dtype, device)}
    if cfg.qk_norm:
        attn["q_norm"] = param((hd,), torch.float32, device)
        attn["k_norm"] = param((hd,), torch.float32, device)
    return nn.ParameterDict(attn)


def init_attn(attn: nn.ParameterDict, cfg: ArchConfig, g: torch.Generator) -> None:
    """The reference's ``attn_params`` distributions."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    for n in ("q_norm", "k_norm"):
        if n in attn:
            attn[n].data.fill_(1.0)
    for n, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", H * hd)):
        w = attn[n]
        w.data.copy_(dense_init(g, w.shape, fan_in, w.dtype, w.device))


def mlp_params(d: int, f: int, dtype: torch.dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"w_gate": param((d, f), dtype, device),
                             "w_up": param((d, f), dtype, device),
                             "w_down": param((f, d), dtype, device)})


def init_mlp(mlp: nn.ParameterDict, g: torch.Generator) -> None:
    for n in ("w_gate", "w_up", "w_down"):
        w = mlp[n]
        w.data.copy_(dense_init(g, w.shape, w.shape[0], w.dtype, w.device))


class Block(nn.Module):
    """One decoder layer: RMSNorm → GQA attention → RMSNorm → SwiGLU."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        f32 = torch.float32
        self.ln1 = param((cfg.d_model,), f32, device)
        self.ln2 = param((cfg.d_model,), f32, device)
        self.attn = attn_params(cfg, dtype, device)
        self.mlp = mlp_params(cfg.d_model, cfg.d_ff, dtype, device)

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        for n in ("ln1", "ln2"):
            getattr(self, n).data.fill_(1.0)
        init_attn(self.attn, cfg, g)
        init_mlp(self.mlp, g)

    def full(self, cfg: ArchConfig, x: torch.Tensor, impl: str = "kernel"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Causal full-sequence layer; returns (x, roped k, v)."""
        o, k, v = attn_full(self.attn, cfg, rms_norm(x, self.ln1, cfg.rms_eps), impl=impl)
        x = x + o
        x = x + swiglu_apply(self.mlp, rms_norm(x, self.ln2, cfg.rms_eps))
        return x, k, v


class DenseLM(nn.Module):
    """Decoder-only LM of the dense family.

    Weights are allocated uninitialised: call :meth:`init` (random, from a
    ``torch.Generator``) or load them (``load_state_dict``, or
    :func:`repro_torch.models.bridge.load_reference_params`)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.moe is not None or cfg.modality is not None:
            raise NotImplementedError(
                f"{cfg.name}: DenseLM serves the dense family only, not {cfg.family!r} "
                "(ROADMAP P11 ports moe/vlm; models.api.get_model builds ssm/hybrid)")
        if cfg.kv_cache_dtype:
            raise NotImplementedError("int8 KV cache is not ported yet (ROADMAP P11)")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_size), dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)

    def init(self, generator: torch.Generator) -> "DenseLM":
        """Random weights with the reference's distributions: N(0, 1/fan_in)
        projections, N(0, 0.02²) embeddings, unit norms."""
        cfg = self.cfg
        self.embed.data.copy_(embed_init(generator, self.embed.shape, self.embed.dtype, self.device))
        self.final_norm.data.fill_(1.0)
        if not cfg.tie_embeddings:
            self.unembed.data.copy_(embed_init(generator, self.unembed.shape,
                                               self.unembed.dtype, self.device))
        for blk in self.layers:
            blk.init(cfg, generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.embed, tokens).to(self.act_dtype)

    def final_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, d] last hidden states -> float32 logits [B, V]."""
        return logits_last(rms_norm(x, self.final_norm, self.cfg.rms_eps),
                           self.unembed_matrix())

    # -- serve: prefill ------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                true_lens: Optional[torch.Tensor] = None,
                impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] -> (next-token logits [B, V], cache).

        ``true_lens`` [B] marks each row's unpadded length when prompts are
        packed into one padded batch: logits are taken at ``true_lens - 1``.
        Padding must be a suffix (causal attention keeps valid positions
        exact).  The cache holds ``k``/``v`` [L, B, capacity, KV, hd] and
        ``lens`` [B].  Attention runs the flash prefill kernel once per layer
        (``impl="kernel"``) or its plain version (``impl="plain"``, for
        oracles).
        """
        B, S = tokens.shape
        capacity = capacity or S
        x = self.embed_tokens(tokens.to(self.device))
        ks, vs = [], []
        for blk in self.layers:
            x, k, v = blk.full(self.cfg, x, impl)
            ks.append(k)
            vs.append(v)
        lens = self._row_lens(B, S, true_lens)
        logits = self._logits_at(x, lens)
        k_all, v_all = torch.stack(ks), torch.stack(vs)
        if capacity > S:
            pad = (0, 0, 0, 0, 0, capacity - S)
            k_all = torch.nn.functional.pad(k_all, pad)
            v_all = torch.nn.functional.pad(v_all, pad)
        return logits, {"k": k_all, "v": v_all, "lens": lens}

    def _row_lens(self, B: int, S: int, true_lens: Optional[torch.Tensor]) -> torch.Tensor:
        if true_lens is None:
            return torch.full((B,), S, dtype=torch.int32, device=self.device)
        return true_lens.to(self.device, torch.int32)

    def _logits_at(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """Next-token logits at each row's last valid position ``lens - 1``."""
        B, S = x.shape[:2]
        return self.final_logits(
            x[torch.arange(B, device=self.device), (lens.long() - 1).clamp(0, S - 1)])

    # -- serve: partial prefill over a cached prefix (prefix cache) ----------
    def _suffix_prefill(self, tokens: torch.Tensor, prefix_lens: torch.Tensor,
                        attend, true_lens: Optional[torch.Tensor]):
        """The layer stack of a suffix prefill: positions offset by
        ``prefix_lens``, each layer's attention ``attend(i, q, k, v)``.
        Returns (logits [B, V], suffix k/v [L, B, S, KV, hd])."""
        cfg, dev = self.cfg, self.device
        B, S = tokens.shape
        prefix_lens = prefix_lens.to(dev)
        positions = prefix_lens.long()[:, None] + torch.arange(S, device=dev)[None, :]
        x = self.embed_tokens(tokens.to(dev))
        ks, vs = [], []
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            q, k, v = project_qkv(blk.attn, cfg, h, positions)
            x = x + out_proj(blk.attn, attend(i, q, k, v).to(x.dtype))
            x = x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps))
            ks.append(k)
            vs.append(v)
        return self._logits_at(x, self._row_lens(B, S, true_lens)), torch.stack(ks), torch.stack(vs)

    @torch.inference_mode()
    def prefill_with_prefix(self, tokens: torch.Tensor, prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, prefix_lens: torch.Tensor, *,
                            true_lens: Optional[torch.Tensor] = None):
        """Prefill only the suffix ``tokens`` [B, S] of prompts whose first
        ``prefix_lens[b]`` tokens have cached K/V: ``prefix_k``/``prefix_v``
        [L, B, T, KV, hd] (roped at their own positions, padded to T).  Every
        layer attends over prefix + causal suffix
        (:func:`~repro_torch.models.attention.prefix_attention`).  Returns
        (next-token logits [B, V], suffix k/v [L, B, S, KV, hd])."""
        dt = self.act_dtype
        pk, pv = prefix_k.to(self.device, dt), prefix_v.to(self.device, dt)
        lens = prefix_lens.to(self.device)
        return self._suffix_prefill(
            tokens, prefix_lens,
            lambda i, q, k, v: attn_lib.prefix_attention(q, pk[i], pv[i], lens, k, v),
            true_lens)

    @torch.inference_mode()
    def prefill_with_host_prefix(self, tokens: torch.Tensor, prefix_lens: torch.Tensor, *,
                                 prefix_cb: Callable,
                                 true_lens: Optional[torch.Tensor] = None):
        """:meth:`prefill_with_prefix` for a prefix the host serves in place
        (zero-copy host serving): every layer hands its suffix queries
        [B, S, H, hd] to ``prefix_cb(layer, q) -> (acc, l, m)``, float32
        flash partials over the host-pool prefix pages (arrays or tensors),
        and merges them with the causal suffix attention on this model's
        device (:func:`~repro_torch.models.attention.suffix_attention_merge`).
        The callback takes the place of the reference's ordered
        ``io_callback``; the prefix itself never crosses PCIe."""
        dev = self.device

        def attend(i, q, k, v):
            acc, l, m = (torch.as_tensor(t).to(dev) for t in prefix_cb(i, q))
            return attn_lib.suffix_attention_merge(q, k, v, acc, l, m)

        return self._suffix_prefill(tokens, prefix_lens, attend, true_lens)

    # -- serve: decode over a contiguous cache (the oracle) ------------------
    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B] -> (logits [B, V], cache).  Writes each row's new K/V
        at position ``lens`` in place (the reference returns a new cache;
        the port updates in place to save a copy of the whole cache) and
        attends over ``lens + 1`` tokens."""
        cfg = self.cfg
        lens = cache["lens"]
        B = tokens.shape[0]
        rows = torch.arange(B, device=self.device)
        pos = lens.long().clamp(0, cache["k"].shape[2] - 1)
        x = self.embed_tokens(tokens.to(self.device))
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            q, k, v = project_qkv(blk.attn, cfg, h[:, None, :], lens[:, None])
            cache["k"][i, rows, pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, rows, pos] = v[:, 0].to(cache["v"].dtype)
            o = attn_lib.decode_attention(q[:, 0], cache["k"][i], cache["v"][i], lens + 1)
            x = x + out_proj(blk.attn, o)
            x = x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps))
        return self.final_logits(x), {**cache, "lens": lens + 1}
