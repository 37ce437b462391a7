"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]

28L d_model=2048 16H (kv=16, i.e. MHA) expert d_ff=1408 vocab=102400,
head_dim=128.  Layer 0 is dense (d_ff=10944), per the paper.
"""

from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense-layer FFN width (layer 0)
    vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=1408,
        interleave=1,
        first_dense_layers=1,
        first_dense_d_ff=10944,
        capacity_factor=1.25,
        dispatch="scatter",
    ),
    kv_shard_mode="heads",  # 16 kv heads == model axis
    opt_state_policy="zero",
    remat_policy="full",
)
