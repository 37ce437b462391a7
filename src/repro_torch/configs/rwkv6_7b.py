"""RWKV6-7B (Finch) — attention-free linear RNN with data-dependent decay.
[arXiv:2404.05892; hf]

32L d_model=4096 d_ff=14336 vocab=65536; 64 heads x head_dim 64.

NEO applicability: attention-free — there is no growing KV cache, so NEO's
KV/attention offloading is inapplicable (DESIGN.md §Arch-applicability).
The engine schedules RWKV requests device-only.
"""

from repro_torch.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk_size=64),
    supports_offload=False,
    kv_shard_mode="heads",  # recurrent-state head dim shards evenly (64 % 16 == 0)
    opt_state_policy="zero",
    remat_policy="full",
    train_micro_tokens=4096,
)
