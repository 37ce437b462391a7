"""SeamlessM4T-medium — encoder–decoder multimodal backbone. [arXiv:2308.11596; hf]

12L (encoder) + 12L (decoder), d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, head_dim=64.

The speech frontend is a stub: ``input_specs()`` provides precomputed frame
embeddings for the encoder.  Decode shapes exercise the decoder (self-attn KV
of the stated length + cross-attention over a fixed 4096-frame encoder memory).
"""

from repro_torch.config import ArchConfig, EncDecConfig, ModalityStub

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    encdec=EncDecConfig(encoder_layers=12, encoder_memory_len=4096),
    modality=ModalityStub(kind="audio", num_embeds=4096, embed_dim=1024),
    kv_shard_mode="heads",  # 16 kv heads == model axis
    opt_state_policy="zero",
    remat_policy="minimal",
)
