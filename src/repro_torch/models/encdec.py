"""Encoder-decoder backbone for the audio family (seamless-m4t-medium), the
port of the JAX package's ``models/encdec.py``.

The speech frontend is a stub: a request brings precomputed frame
embeddings ``frames`` [B, F, d].  The encoder projects them through
``frame_in`` and runs non-causal self-attention layers (the flash prefill
kernel, ``causal=False``); the decoder is a causal LM (its self-attention
prefill runs the same kernel) with cross-attention over the encoder memory.
Cross-attention stays plain at prefill: its query and memory lengths
differ, and the kernel takes equal ones.  Decode attends over a
self-attention cache and over the per-layer cross K/V computed once at
prefill, both with the plain decode attention.

Parameters keep the reference's names and layouts; the stacked
``enc_blocks`` / ``dec_blocks`` of the reference are ``nn.ModuleList``\\ s
here (:mod:`repro_torch.models.bridge` unstacks them).  The cache is the
reference's dict: ``k``/``v`` [L, B, capacity, KV, hd], ``ck``/``cv``
[L, B, F, KV, hd], ``lens`` and ``enc_lens`` [B].  The training loss
(:meth:`EncDecLM.loss`) runs every attention plain.
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
    rows_matmul,
    serving,
    softmax_xent,
    swiglu_apply,
    swiglu_logical_axes,
    zeros_cache,
)
from repro_torch.models.transformer import (
    attn_full,
    attn_logical_axes,
    attn_params,
    init_attn,
    out_proj,
    project_qkv,
)

Cache = Dict[str, torch.Tensor]


class EncLayer(nn.Module):
    """RMSNorm → self-attention → RMSNorm → SwiGLU (the decoder layer adds
    cross-attention between them)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device, *, cross: bool = False):
        super().__init__()
        f32 = torch.float32
        self.ln1 = param((cfg.d_model,), f32, device)
        self.attn = attn_params(cfg, dtype, device)
        self.ln2 = param((cfg.d_model,), f32, device)
        self.mlp = mlp_params(cfg.d_model, cfg.d_ff, dtype, device)
        if cross:
            self.ln_c = param((cfg.d_model,), f32, device)
            self.cross = attn_params(cfg, dtype, device)

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        for norm in self.parameters(recurse=False):  # ln1, ln2 (and ln_c)
            norm.data.fill_(1.0)
        init_attn(self.attn, cfg, g)
        init_mlp(self.mlp, g)
        if hasattr(self, "cross"):
            init_attn(self.cross, cfg, g)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] through ``w`` [d, H, hd] -> [..., H, hd] (no RoPE: cross
    attention)."""
    d, H, hd = w.shape
    return rows_matmul(x, w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


class EncDecLM(nn.Module):
    """Encoder-decoder LM.  Weights are allocated uninitialised: call
    :meth:`init` (random, from a ``torch.Generator``) or load them."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name}: EncDecLM needs an encdec config")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = param((V, d), dtype, dev)
        self.frame_in = param((d, d), dtype, dev)
        self.enc_norm = param((d,), torch.float32, dev)
        self.final_norm = param((d,), torch.float32, dev)
        self.unembed = param((d, V), dtype, dev)
        self.enc_blocks = nn.ModuleList(EncLayer(cfg, dtype, dev)
                                        for _ in range(cfg.encdec.encoder_layers))
        self.dec_blocks = nn.ModuleList(EncLayer(cfg, dtype, dev, cross=True)
                                        for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights with the reference's distributions."""
        cfg, g = self.cfg, generator
        for name in ("embed", "unembed"):
            t = getattr(self, name)
            t.data.copy_(embed_init(g, t.shape, t.dtype, self.device))
        self.frame_in.data.copy_(dense_init(g, self.frame_in.shape, None,
                                            self.frame_in.dtype, self.device))
        self.enc_norm.data.fill_(1.0)
        self.final_norm.data.fill_(1.0)
        for blk in list(self.enc_blocks) + list(self.dec_blocks):
            blk.init(cfg, g)
        return self

    def param_logical_axes(self) -> Dict[str, Tuple]:
        """{parameter name: logical axes}, the reference's axes (its stacked
        leaves' leading layer axis dropped)."""
        cfg = self.cfg
        enc = {"ln1": (None,), "attn": attn_logical_axes(cfg), "ln2": (None,),
               "mlp": swiglu_logical_axes()}
        dec = {**enc, "ln_c": (None,), "cross": attn_logical_axes(cfg)}
        ax = {"embed": ("vocab", None), "frame_in": (None, None), "enc_norm": (None,),
              "final_norm": (None,), "unembed": (None, "vocab")}
        for i in range(len(self.enc_blocks)):
            ax.update(flat_axes(f"enc_blocks.{i}.", enc))
        for i in range(len(self.dec_blocks)):
            ax.update(flat_axes(f"dec_blocks.{i}.", dec))
        return ax

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- encoder -----------------------------------------------------------------
    def _enc_layer(self, blk: EncLayer, x: torch.Tensor, impl: str) -> torch.Tensor:
        cfg = self.cfg
        o, _, _ = attn_full(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.rms_eps),
                            causal=False, impl=impl)
        x = x + o
        return shard(x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps)),
                     "batch", "seq", None)

    def encode(self, frames: torch.Tensor, impl: str = "kernel",
               remat: str = "none") -> torch.Tensor:
        """frames [B, F, d] (the stubbed frontend's) -> memory [B, F, d];
        each layer checkpointed under ``remat`` (a ``remat_policy``)."""
        x = torch.as_tensor(frames).to(self.device, self.act_dtype) @ self.frame_in
        x = shard(x, "batch", None, None)
        for blk in self.enc_blocks:
            x = maybe_remat(lambda x, blk=blk: self._enc_layer(blk, x, impl), remat)(x)
        return rms_norm(x, self.enc_norm, self.cfg.rms_eps)

    # -- train -------------------------------------------------------------------
    def _dec_layer(self, blk: EncLayer, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """One decoder layer of the training loss: causal self attention,
        cross attention over ``memory``, SwiGLU; all plain."""
        cfg = self.cfg
        o, _, _ = attn_full(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.rms_eps),
                            causal=True, impl="plain")
        x = x + o
        ck, cv = _heads(memory, blk.cross["wk"]), _heads(memory, blk.cross["wv"])
        q = _heads(rms_norm(x, blk.ln_c, cfg.rms_eps), blk.cross["wq"])
        x = x + out_proj(blk.cross, attn_lib.chunked_attention(q, ck, cv, causal=False))
        return shard(x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps)),
                     "batch", "seq", None)

    def loss(self, batch: Dict[str, torch.Tensor]):
        """The reference's training loss: the encoder over ``frames``
        [B, F, d], then the decoder over ``tokens`` against ``targets`` and
        ``loss_mask``, every layer checkpointed under ``remat_policy`` and
        every attention plain.  Returns (xent, {"xent", "aux": 0})."""
        cfg, dev = self.cfg, self.device
        memory = self.encode(batch["frames"], impl="plain", remat=cfg.remat_policy)
        x = shard(embed_lookup(self.embed, batch["tokens"].to(dev)).to(self.act_dtype),
                  "batch", None, None)
        for blk in self.dec_blocks:
            x = maybe_remat(lambda x, mem, blk=blk: self._dec_layer(blk, x, mem),
                            cfg.remat_policy)(x, memory)
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        xent, _ = softmax_xent(x, self.unembed, batch["targets"].to(dev),
                               batch["loss_mask"].to(dev))
        return xent, {"xent": xent, "aux": xent.new_zeros(())}

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """{name: (shape, dtype name, logical axes)} of a dry-run cell's
        inputs: the token inputs and the stubbed audio frontend's
        ``frames`` [B, F, d] (F cut to S to train) for train and prefill."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        F = cfg.encdec.encoder_memory_len
        specs = token_specs(shape)
        if shape.kind in ("train", "prefill"):
            n = min(F, S) if shape.kind == "train" else F
            specs["frames"] = ((B, n, cfg.d_model), cfg.activation_dtype, ("batch", None, None))
            if shape.kind == "train":  # the reference's key order
                specs = {"frames": specs.pop("frames"), **specs}
        return specs

    # -- cache -------------------------------------------------------------------
    def cache_shape(self, batch: int, capacity: int):
        """{name: (shape, dtype name, logical axes)}, as the reference's."""
        cfg = self.cfg
        L, F = cfg.num_layers, cfg.encdec.encoder_memory_len
        kv = (cfg.num_kv_heads, cfg.head_dim)
        self_ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        cross_ax = ("layers", "batch", None, "kv_heads", None)
        adt = cfg.activation_dtype
        return {
            "k": ((L, batch, capacity, *kv), adt, self_ax),
            "v": ((L, batch, capacity, *kv), adt, self_ax),
            "ck": ((L, batch, F, *kv), adt, cross_ax),
            "cv": ((L, batch, F, *kv), adt, cross_ax),
            "lens": ((batch,), "int32", ("batch",)),
            "enc_lens": ((batch,), "int32", ("batch",)),
        }

    def init_cache(self, batch: int, capacity: int) -> Cache:
        return zeros_cache(self.cache_shape(batch, capacity), self.device)

    # -- serve -------------------------------------------------------------------
    @serving
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                frames: torch.Tensor, impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] and ``frames`` [B, F, d] -> (next-token logits
        [B, V] f32, cache).  ``impl`` picks the self-attention (encoder and
        decoder): the flash prefill kernel or its plain version."""
        cfg = self.cfg
        B, S = tokens.shape
        capacity = capacity or S
        memory = self.encode(frames, impl)
        x = shard(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                  "batch", None, None)
        ks, vs, cks, cvs = [], [], [], []
        for blk in self.dec_blocks:
            o, k, v = attn_full(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.rms_eps),
                                causal=True, impl=impl)
            x = x + o
            ck, cv = _heads(memory, blk.cross["wk"]), _heads(memory, blk.cross["wv"])
            q = _heads(rms_norm(x, blk.ln_c, cfg.rms_eps), blk.cross["wq"])
            x = x + out_proj(blk.cross, attn_lib.chunked_attention(q, ck, cv, causal=False))
            x = x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps))
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
        logits = logits_last(rms_norm(x[:, -1], self.final_norm, cfg.rms_eps), self.unembed)
        k_all, v_all = torch.stack(ks), torch.stack(vs)
        if capacity > S:
            pad = (0, 0, 0, 0, 0, capacity - S)
            k_all = torch.nn.functional.pad(k_all, pad)
            v_all = torch.nn.functional.pad(v_all, pad)
        dev = self.device
        return logits, {
            "k": k_all, "v": v_all, "ck": torch.stack(cks), "cv": torch.stack(cvs),
            "lens": torch.full((B,), S, dtype=torch.int32, device=dev),
            "enc_lens": torch.full((B,), memory.shape[1], dtype=torch.int32, device=dev),
        }

    @serving
    def decode(self, tokens: torch.Tensor, cache: Cache,
               active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens [B] -> (logits [B, V] f32, cache).  Writes each row's new
        self-attention K/V at ``lens`` in place, for the ``active`` rows only
        when given (the others are computed, and their cache and ``lens``
        are left as they were); cross-attention reads ``enc_lens`` memory
        positions."""
        cfg = self.cfg
        cache = reduce_partials(cache)
        lens = cache["lens"]
        rows = None if active is None else active.nonzero()[:, 0]
        x = shard(embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype),
                  "batch", None)
        for i, blk in enumerate(self.dec_blocks):
            q, k, v = project_qkv(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.rms_eps)[:, None, :],
                                  lens[:, None])
            attn_lib.write_kv(cache["k"][i], cache["v"][i], k[:, 0], v[:, 0], lens, rows=rows)
            o = attn_lib.decode_attention(q[:, 0], cache["k"][i], cache["v"][i], lens + 1)
            x = x + out_proj(blk.attn, o)
            qc = _heads(rms_norm(x, blk.ln_c, cfg.rms_eps), blk.cross["wq"])
            oc = attn_lib.decode_attention(qc, cache["ck"][i], cache["cv"][i], cache["enc_lens"])
            x = x + out_proj(blk.cross, oc)
            x = x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps))
        logits = logits_last(rms_norm(x, self.final_norm, cfg.rms_eps), self.unembed)
        step = 1 if active is None else active.to(lens.dtype)
        return logits, {**cache, "lens": lens + step}
