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
[L, B, F, KV, hd], ``lens`` and ``enc_lens`` [B].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    embed_lookup,
    init_mlp,
    logits_last,
    mlp_params,
    param,
    rms_norm,
    swiglu_apply,
    zeros_cache,
)
from repro_torch.models.transformer import (
    attn_full,
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
    return (x @ w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


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

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- encoder -----------------------------------------------------------------
    def encode(self, frames: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        """frames [B, F, d] (the stubbed frontend's) -> memory [B, F, d]."""
        cfg = self.cfg
        x = torch.as_tensor(frames).to(self.device, self.act_dtype) @ self.frame_in
        for blk in self.enc_blocks:
            o, _, _ = attn_full(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.rms_eps),
                                causal=False, impl=impl)
            x = x + o
            x = x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.rms_eps))
        return rms_norm(x, self.enc_norm, cfg.rms_eps)

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
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                frames: torch.Tensor, impl: str = "kernel") -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] and ``frames`` [B, F, d] -> (next-token logits
        [B, V] f32, cache).  ``impl`` picks the self-attention (encoder and
        decoder): the flash prefill kernel or its plain version."""
        cfg = self.cfg
        B, S = tokens.shape
        capacity = capacity or S
        memory = self.encode(frames, impl)
        x = embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype)
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

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens [B] -> (logits [B, V] f32, cache).  Writes each row's new
        self-attention K/V at ``lens`` in place, for the ``active`` rows only
        when given (the others are computed, and their cache and ``lens``
        are left as they were); cross-attention reads ``enc_lens`` memory
        positions."""
        cfg = self.cfg
        lens = cache["lens"]
        rows = None if active is None else active.nonzero()[:, 0]
        x = embed_lookup(self.embed, tokens.to(self.device)).to(self.act_dtype)
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
