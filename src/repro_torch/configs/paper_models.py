"""The paper's evaluation models (§5.1): LLaMa-2-7B, LLaMa-3.1-8B and
LLaMa-3.1-70B.  Not part of the assigned 40-cell grid — they exist so the
paper-figure benchmarks replay the published setups exactly.
[arXiv:2307.09288, arXiv:2407.21783; hf]"""

from repro_torch.config import ArchConfig
from repro_torch.configs import register

LLAMA2_7B = register(ArchConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,  # MHA
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10_000.0,
    kv_shard_mode="heads",
))

LLAMA31_8B = register(ArchConfig(
    name="llama31-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    kv_shard_mode="blocks",
))

LLAMA31_70B = register(ArchConfig(
    name="llama31-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    kv_shard_mode="blocks",
    remat_policy="minimal",
))
