"""Zamba2-7B — hybrid: Mamba2 blocks + shared attention blocks.
[arXiv:2411.15242; unverified]

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
head_dim = 3584/32 = 112 (padded to 128 lanes inside the Pallas kernels).

Structure (simplified per DESIGN.md): 81 Mamba2 blocks with one *shared*
full-attention transformer block applied every 6 blocks (weights shared across
applications; the per-application LoRA of the paper is omitted), with the
concat-from-embedding skip. In long-context (``long_500k``) mode the shared
attention blocks use a 32k sliding window so KV stays bounded.
"""

from repro_torch.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10_000.0,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2, conv_kernel=4, chunk_size=64),
    shared_attn_every=6,
    long_context_window=32_768,
    kv_shard_mode="heads",  # 32 kv heads % 16 == 0
    opt_state_policy="zero",
    remat_policy="full",
    train_micro_tokens=4096,
)
