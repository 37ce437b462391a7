"""Yi-9B — llama-architecture dense GQA transformer. [arXiv:2403.04652; hf]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, head_dim=128.
"""

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    qk_norm=False,
    rope_theta=10_000.0,
    kv_shard_mode="blocks",  # 4 kv heads < 16-way model axis
    opt_state_policy="zero",
    remat_policy="full",
)
