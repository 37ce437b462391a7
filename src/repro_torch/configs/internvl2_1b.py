"""InternVL2-1B — InternViT + Qwen2-0.5B LM backbone. [arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655, head_dim=64.

Per the assignment, only the transformer BACKBONE is modelled; the InternViT
frontend is a stub — ``input_specs()`` provides precomputed patch embeddings
(256 patches, projected to d_model) that are merged into the token stream at
prefill.
"""

from repro_torch.config import ArchConfig, ModalityStub

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    modality=ModalityStub(kind="vision", num_embeds=256, embed_dim=896),
    kv_shard_mode="blocks",  # 2 kv heads << 16-way model axis
    opt_state_policy="zero",
    remat_policy="minimal",
)
