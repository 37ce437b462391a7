"""Llama-4 Maverick 400B-A17B — MoE top-1, GQA, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1,
head_dim=128.

Structure note (DESIGN.md §Arch-applicability): the flat listed config
(MoE on all 48 layers) totals ~773B params, contradicting "400B-A17B".
We follow the published Maverick layout — MoE on alternating layers
(interleave=2) with 1 shared expert — which reproduces ~400B total /
~17B active while keeping every listed hyperparameter.  "Early fusion"
is the multimodal token fusion; the modality frontend is stubbed.
"""

from repro_torch.config import ArchConfig, MoEConfig, ModalityStub

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # dense-layer FFN width
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        expert_d_ff=8192,
        num_shared_experts=1,
        shared_d_ff=8192,
        interleave=2,  # MoE on alternating layers (published Maverick layout)
        capacity_factor=1.25,
        dispatch="scatter",
    ),
    modality=ModalityStub(kind="vision", num_embeds=0, embed_dim=5120),
    kv_shard_mode="blocks",  # 8 kv heads < 16-way model axis
    # 400B params: bf16 optimizer first moment + factored second moment so the
    # train_4k cell fits 16 GB/chip on the single-pod mesh (DESIGN.md §5).
    opt_state_policy="lite",
    remat_policy="full",
    # 772 GB of expert weights cannot live on the 16-way model axis alone:
    # shard each expert's d_ff over "data" too (2-D expert sharding, 3 GB/chip).
    sharding_overrides=(("expert_ff", "data"),),
)
