"""Qwen3-14B — dense GQA transformer with qk_norm. [hf:Qwen/Qwen3-8B family; hf]

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, head_dim=128.
"""

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    kv_shard_mode="blocks",
    opt_state_policy="zero",
    remat_policy="full",
)
