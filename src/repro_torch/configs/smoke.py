"""Reduced same-family configs for CPU smoke tests.

Small layers/width, few experts, tiny vocab — same structural family as the
full config, so one forward/train step on CPU exercises the same code paths.
"""

from __future__ import annotations

import dataclasses

from repro_torch.config import ArchConfig, EncDecConfig, ModalityStub, MoEConfig, SSMConfig


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else 7),
        d_model=128,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        kv_shard_mode="replicated",
        remat_policy="none",
        param_dtype="float32",
        activation_dtype="float32",
        long_context_window=min(cfg.long_context_window, 64) if cfg.long_context_window else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            shared_d_ff=64,
            interleave=cfg.moe.interleave,
            first_dense_layers=cfg.moe.first_dense_layers,
            first_dense_d_ff=256,
            capacity_factor=2.0,
            dispatch=cfg.moe.dispatch,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            kind=cfg.ssm.kind,
            state_dim=16,
            head_dim=32,
            expand=2,
            conv_kernel=cfg.ssm.conv_kernel,
            chunk_size=8,
        )
        if cfg.family == "ssm":
            # rwkv: heads * head_dim == d_model
            kw["num_heads"] = kw["d_model"] // kw["ssm"].head_dim
            kw["num_kv_heads"] = kw["num_heads"]
    if cfg.family == "hybrid":
        kw["shared_attn_every"] = 3
        kw["head_dim"] = kw["d_model"] // kw["num_heads"]
        kw["num_kv_heads"] = kw["num_heads"]
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(encoder_layers=2, encoder_memory_len=32)
    if cfg.modality is not None:
        kw["modality"] = ModalityStub(
            kind=cfg.modality.kind,
            num_embeds=min(cfg.modality.num_embeds, 16) if cfg.modality.num_embeds else 0,
            embed_dim=kw["d_model"],
        )
    return dataclasses.replace(cfg, **kw)
