"""Decoder-only LM for the dense, moe and vlm families (qwen3-*, yi-9b, the
paper's LLaMa models, deepseek-moe-16b, llama4-maverick, internvl2-1b).

Parameters live in an ``nn.Module`` tree whose leaves keep the JAX
package's layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, ``w_gate [d, f]``,
``moe.w_gate [E, d, ff]``) so :mod:`repro_torch.models.bridge` maps one onto
the other leaf for leaf.  Layers are an ``nn.ModuleList`` instead of the
reference's ``vmap``-stacked groups; their kinds follow the reference's
pattern (:func:`layer_pattern`: ``first_dense_layers`` of kind ``dense0``,
then groups of ``["moe"] + ["dense"] * (interleave - 1)``), and every FFN
goes through :func:`mlp_apply`.  The serve entry points are
:meth:`DenseLM.prefill` (cold prefill, per-layer K/V out; a vlm's patch
embeddings replace the first positions), :meth:`DenseLM.decode` (one token
over a contiguous cache — the dense oracle the paged engine is held to;
with ``kv_cache_dtype="int8"`` over the quantised cache) and, for
prefix-cache hits, :meth:`DenseLM.prefill_with_prefix` (the suffix over a
cached prefix gathered from the device pool) and
:meth:`DenseLM.prefill_with_host_prefix` (the suffix over a prefix the host
serves in place, through a per-layer callback).

Tensor-parallel serving (gather-TP, :mod:`repro_torch.distributed.sharding`)
passes ``shards``: per layer, one dict per shard of its column slices
(``wq``/``wk``/``wv`` over its heads, ``w_gate``/``w_up`` over its d_ff
columns, the replicated qk-norm scales), each on its shard's device.  The
model keeps the reference's two seams: each shard's attention output is
concatenated on the head axis before the replicated ``wo``, and its SwiGLU
hidden on d_ff before the replicated ``w_down``; both on this model's
device, where the replicated layers run once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import tp_allgather
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    init_mlp,
    logits_last,
    mlp_params,
    param,
    rms_norm,
    swiglu_apply,
    swiglu_hidden,
    zeros_cache,
)
from repro_torch.models.moe import MoE, moe_apply

Cache = Dict[str, torch.Tensor]
# per layer, one dict of column slices per tensor-parallel shard
Shards = List[Dict[str, torch.Tensor]]


def project_qkv(p, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor):
    """h: [B, S, d]; positions: [B, S] or [S].  Returns roped q [B,S,H,hd],
    k and v [B,S,KV,hd], where H and KV are the head counts of ``p``'s
    columns: a tensor-parallel shard passes its slice (H/tp, KV/tp)."""
    B, S, d = h.shape
    H, KV, hd = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
    q = (h @ p["wq"].reshape(d, -1)).view(B, S, H, hd)
    k = (h @ p["wk"].reshape(d, -1)).view(B, S, KV, hd)
    v = (h @ p["wv"].reshape(d, -1)).view(B, S, KV, hd)
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


def attn_full_tp(p, shards: Shards, cfg: ArchConfig, x: torch.Tensor, *,
                 impl: str = "kernel"):
    """:func:`attn_full` (causal) under tensor parallelism: each shard
    projects its heads and runs the prefill attention on its device, and the
    outputs are concatenated on the head axis before the replicated ``wo``.
    Returns (out [B, S, d], per-shard roped k and v [B, S, KV/tp, hd])."""
    S = x.shape[1]
    outs, ks, vs = [], [], []
    for sp in shards:
        dev = sp["wq"].device
        q, k, v = project_qkv(sp, cfg, x.to(dev), torch.arange(S, device=dev))
        outs.append(attn_lib.prefill_attention(q, k, v, causal=True, impl=impl))
        ks.append(k)
        vs.append(v)
    return out_proj(p, tp_allgather(outs, 2, x.device)), ks, vs


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


def layer_pattern(cfg: ArchConfig) -> Tuple[List[str], List[str], int]:
    """The reference's ``DenseLM._pattern``: (prefix kinds, the kinds of
    one repeated group, the number of groups)."""
    if cfg.moe is None:
        return [], ["dense"], cfg.num_layers
    moe = cfg.moe
    prefix = ["dense0"] * moe.first_dense_layers
    rem = cfg.num_layers - moe.first_dense_layers
    if moe.interleave == 1:
        return prefix, ["moe"], rem
    if rem % moe.interleave != 0:
        raise ValueError("num_layers incompatible with moe.interleave")
    return prefix, ["moe"] + ["dense"] * (moe.interleave - 1), rem // moe.interleave


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """[..., KV, hd] -> int8 codes and per-(position, head) float32 scales
    ``max|x| / 127 + 1e-8`` (round half to even, as ``jnp.round``)."""
    def q8(x):
        x = x.float()
        scale = x.abs().amax(dim=-1) / 127.0 + 1e-8
        return torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8), scale

    kq, ks = q8(k)
    vq, vs = q8(v)
    return kq, vq, ks, vs


def mlp_apply(blk: "Block", x: torch.Tensor,
              shards: Optional[Shards] = None) -> torch.Tensor:
    """The layer's FFN: SwiGLU, or the MoE for a ``moe`` layer.  A 2-D
    ``x`` [B, d] (a decode pass) goes through the MoE as B rows of one
    token each, as the reference's decode does.  With a dense layer's
    ``shards`` each shard computes its d_ff columns of the SwiGLU hidden on
    its device, concatenated before the replicated ``w_down``."""
    if blk.kind != "moe":
        if shards is None:
            return swiglu_apply(blk.mlp, x)
        h = tp_allgather([swiglu_hidden(sp, x.to(sp["w_gate"].device)) for sp in shards],
                         -1, x.device)
        return h @ blk.mlp["w_down"]
    if x.ndim == 2:
        return moe_apply(blk.moe, x[:, None, :], blk.moe.cfg)[0][:, 0]
    return moe_apply(blk.moe, x, blk.moe.cfg)[0]


class Block(nn.Module):
    """One decoder layer: RMSNorm → GQA attention → RMSNorm → FFN, where the
    FFN is a SwiGLU (kinds ``dense`` and ``dense0``, the latter at
    ``first_dense_d_ff``) or the MoE (kind ``moe``)."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype: torch.dtype, device):
        super().__init__()
        f32 = torch.float32
        self.kind = kind
        self.ln1 = param((cfg.d_model,), f32, device)
        self.ln2 = param((cfg.d_model,), f32, device)
        self.attn = attn_params(cfg, dtype, device)
        if kind == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe, dtype, device)
        else:
            width = cfg.moe.first_dense_d_ff if kind == "dense0" and cfg.moe else cfg.d_ff
            self.mlp = mlp_params(cfg.d_model, width, dtype, device)

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        for n in ("ln1", "ln2"):
            getattr(self, n).data.fill_(1.0)
        init_attn(self.attn, cfg, g)
        if self.kind == "moe":
            self.moe.init(g)
        else:
            init_mlp(self.mlp, g)

    def full(self, cfg: ArchConfig, x: torch.Tensor, impl: str = "kernel",
             shards: Optional[Shards] = None):
        """Causal full-sequence layer; returns (x, roped k, v), with
        ``shards`` the per-shard lists of k and v."""
        h = rms_norm(x, self.ln1, cfg.rms_eps)
        if shards is None:
            o, k, v = attn_full(self.attn, cfg, h, impl=impl)
        else:
            o, k, v = attn_full_tp(self.attn, shards, cfg, h, impl=impl)
        x = x + o
        x = x + mlp_apply(self, rms_norm(x, self.ln2, cfg.rms_eps), shards)
        return x, k, v


class DenseLM(nn.Module):
    """Decoder-only LM of the dense, moe and vlm families.

    Weights are allocated uninitialised: call :meth:`init` (random, from a
    ``torch.Generator``) or load them (``load_state_dict``, or
    :func:`repro_torch.models.bridge.load_reference_params`)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: DenseLM serves the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        if cfg.kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_size), dtype, dev)
        prefix, group, n_groups = layer_pattern(cfg)
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, dev)
                                    for kind in prefix + group * n_groups)

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

    def _embed_prompt(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's ``_embed_tokens``: a vlm's ``patch_embeds``
        [B, P, d] replace the first P positions, in the activation dtype,
        whenever the (padded) prompt holds at least P positions."""
        x = self.embed_tokens(tokens.to(self.device))
        P = self.cfg.modality.num_embeds if self.cfg.modality is not None else 0
        if P and patch_embeds is not None and tokens.shape[1] >= P:
            pe = torch.as_tensor(patch_embeds).to(self.device, self.act_dtype)
            x = torch.cat([pe, x[:, P:]], dim=1)
        return x

    # -- serve: cache --------------------------------------------------------
    def cache_shape(self, batch: int, capacity: int):
        """{name: (shape, dtype name, logical axes)} of the contiguous cache:
        ``k``/``v`` [L, B, capacity, KV, hd] in the activation dtype, or in
        int8 with float32 ``k_scale``/``v_scale`` [L, B, capacity, KV] when
        ``kv_cache_dtype == "int8"``, and ``lens`` [B]."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        lens = {"lens": ((batch,), "int32", ("batch",))}
        if cfg.kv_cache_dtype == "int8":
            sc = kv[:-1]
            return {"k": (kv, "int8", axes), "v": (kv, "int8", axes),
                    "k_scale": (sc, "float32", axes[:-1]),
                    "v_scale": (sc, "float32", axes[:-1]), **lens}
        return {"k": (kv, cfg.activation_dtype, axes),
                "v": (kv, cfg.activation_dtype, axes), **lens}

    def init_cache(self, batch: int, capacity: int) -> Cache:
        return zeros_cache(self.cache_shape(batch, capacity), self.device)

    # -- serve: prefill ------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                true_lens: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                impl: str = "kernel",
                shards: Optional[List[Shards]] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] -> (next-token logits [B, V], cache).

        ``true_lens`` [B] marks each row's unpadded length when prompts are
        packed into one padded batch: logits are taken at ``true_lens - 1``.
        Padding must be a suffix (causal attention keeps valid positions
        exact); a moe layer's capacity follows the padded S.  A vlm's
        ``patch_embeds`` [B, P, d] replace the first P positions when
        S >= P.  The cache holds ``k``/``v`` [L, B, capacity, KV, hd] (int8
        codes plus ``k_scale``/``v_scale`` with ``kv_cache_dtype="int8"``)
        and ``lens`` [B].  Attention runs the flash prefill kernel once per
        layer (``impl="kernel"``) or its plain version (``impl="plain"``,
        for oracles).  With tensor-parallel ``shards`` (per layer) each
        shard's attention runs on its device and ``k``/``v`` are lists of the
        shards' [L, B, S, KV/tp, hd].
        """
        B, S = tokens.shape
        capacity = capacity or S
        x = self._embed_prompt(tokens, patch_embeds)
        ks, vs = [], []
        for i, blk in enumerate(self.layers):
            x, k, v = blk.full(self.cfg, x, impl, None if shards is None else shards[i])
            ks.append(k)
            vs.append(v)
        lens = self._row_lens(B, S, true_lens)
        logits = self._logits_at(x, lens)
        if shards is not None:
            return logits, {"k": [torch.stack(k) for k in zip(*ks)],
                            "v": [torch.stack(v) for v in zip(*vs)], "lens": lens}
        k_all, v_all = torch.stack(ks), torch.stack(vs)
        if capacity > S:
            pad = (0, 0, 0, 0, 0, capacity - S)
            k_all = torch.nn.functional.pad(k_all, pad)
            v_all = torch.nn.functional.pad(v_all, pad)
        if self.cfg.kv_cache_dtype == "int8":
            kq, vq, k_scale, v_scale = quantize_kv(k_all, v_all)
            return logits, {"k": kq, "v": vq, "k_scale": k_scale, "v_scale": v_scale,
                            "lens": lens}
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
                        attend, true_lens: Optional[torch.Tensor],
                        shards: Optional[List[Shards]] = None):
        """The layer stack of a suffix prefill: positions offset by
        ``prefix_lens``, each layer's attention ``attend(i, q, k, v)``; with
        tensor-parallel ``shards``, ``attend(i, qs, ks, vs)`` over the
        shards' lists returns the shards' outputs.  Returns (logits [B, V],
        suffix k/v [L, B, S, KV, hd] on this model's device)."""
        cfg, dev = self.cfg, self.device
        B, S = tokens.shape
        prefix_lens = prefix_lens.to(dev)
        positions = prefix_lens.long()[:, None] + torch.arange(S, device=dev)[None, :]
        x = self.embed_tokens(tokens.to(dev))
        ks, vs = [], []
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            sh = None if shards is None else shards[i]
            if sh is None:
                q, k, v = project_qkv(blk.attn, cfg, h, positions)
                o = attend(i, q, k, v)
            else:
                qs, kss, vss = map(list, zip(*(
                    project_qkv(sp, cfg, h.to(sp["wq"].device), positions.to(sp["wq"].device))
                    for sp in sh)))
                o = tp_allgather(attend(i, qs, kss, vss), 2, dev)
                k, v = tp_allgather(kss, 2, dev), tp_allgather(vss, 2, dev)
            x = x + out_proj(blk.attn, o.to(x.dtype))
            x = x + mlp_apply(blk, rms_norm(x, blk.ln2, cfg.rms_eps), sh)
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
                                 true_lens: Optional[torch.Tensor] = None,
                                 shards: Optional[List[Shards]] = None):
        """:meth:`prefill_with_prefix` for a prefix the host serves in place
        (zero-copy host serving): every layer hands its suffix queries
        [B, S, H, hd] to ``prefix_cb(layer, q) -> (acc, l, m)``, float32
        flash partials over the host-pool prefix pages (arrays or tensors),
        and merges them with the causal suffix attention on this model's
        device (:func:`~repro_torch.models.attention.suffix_attention_merge`).
        The callback takes the place of the reference's ordered
        ``io_callback``; the prefix itself never crosses PCIe.  With
        tensor-parallel ``shards``, ``prefix_cb(layer, qs)`` takes the
        shards' queries [B, S, H/tp, hd] and returns one partial per shard,
        each merged on its shard's device."""
        dev = self.device

        def attend(i, q, k, v):
            acc, l, m = (torch.as_tensor(t).to(dev) for t in prefix_cb(i, q))
            return attn_lib.suffix_attention_merge(q, k, v, acc, l, m)

        def attend_tp(i, qs, ks, vs):
            return [attn_lib.suffix_attention_merge(
                q, k, v, *(torch.as_tensor(t).to(q.device) for t in part))
                for q, k, v, part in zip(qs, ks, vs, prefix_cb(i, qs))]

        return self._suffix_prefill(tokens, prefix_lens, attend if shards is None else attend_tp,
                                    true_lens, shards)

    # -- serve: decode over a contiguous cache (the oracle) ------------------
    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B] -> (logits [B, V], cache).  Writes each row's new K/V
        at position ``lens`` in place (the reference returns a new cache;
        the port updates in place to save a copy of the whole cache) and
        attends over ``lens + 1`` tokens.  Over an int8 cache the new K/V
        are quantised, and each layer attends over its cache dequantised to
        the activation dtype (the reference's ``attn_decode_int8``)."""
        cfg = self.cfg
        lens = cache["lens"]
        B = tokens.shape[0]
        rows = torch.arange(B, device=self.device)
        pos = lens.long().clamp(0, cache["k"].shape[2] - 1)
        int8 = cfg.kv_cache_dtype == "int8"
        x = self.embed_tokens(tokens.to(self.device))
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            q, k, v = project_qkv(blk.attn, cfg, h[:, None, :], lens[:, None])
            if int8:
                kq, vq, k_scale, v_scale = quantize_kv(k[:, 0], v[:, 0])
                for name, new in (("k", kq), ("v", vq), ("k_scale", k_scale),
                                  ("v_scale", v_scale)):
                    cache[name][i, rows, pos] = new
                dt = self.act_dtype
                kc = cache["k"][i].to(dt) * cache["k_scale"][i][..., None].to(dt)
                vc = cache["v"][i].to(dt) * cache["v_scale"][i][..., None].to(dt)
            else:
                cache["k"][i, rows, pos] = k[:, 0].to(cache["k"].dtype)
                cache["v"][i, rows, pos] = v[:, 0].to(cache["v"].dtype)
                kc, vc = cache["k"][i], cache["v"][i]
            o = attn_lib.decode_attention(q[:, 0], kc, vc, lens + 1)
            x = x + out_proj(blk.attn, o)
            x = x + mlp_apply(blk, rms_norm(x, blk.ln2, cfg.rms_eps))
        return self.final_logits(x), {**cache, "lens": lens + 1}
