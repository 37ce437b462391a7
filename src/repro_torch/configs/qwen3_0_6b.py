"""Qwen3-0.6B — dense GQA transformer with qk_norm. [hf:Qwen/Qwen3-8B family; hf]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128.
"""

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    # 8 kv heads do not divide the 16-way model axis: decode KV pages are
    # sharded over "model" and decode attention runs split-K (shard_map).
    kv_shard_mode="blocks",
    opt_state_policy="zero",
    remat_policy="full",
)
