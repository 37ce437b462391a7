"""Qwen3-32B — dense GQA transformer with qk_norm. [hf:Qwen/Qwen3-8B family; hf]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128.
"""

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    kv_shard_mode="blocks",
    opt_state_policy="zero",
    remat_policy="full",
)
