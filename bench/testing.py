"""Smoke-size configurations and mixes for the benchmark's CPU tests, in the
same form as ``configs/<name>.json`` and ``traffic/<mix>.json``.  The smoke
models run in float32: a bf16 MoE this small flips near-tied experts under
its capacity of 1.0 so often that its gaps reach the float8 control's
(32 seeds: mean gap up to 0.0038 against the control's 0.0044), and a
smoke run's batches follow the host's timing.  The limits lie between the
float32 program's readings (0 on 28 seeds) and the control's (dense widest
gap >= 0.0218, MoE mean gap >= 0.00315, on 28 seeds each)."""

from __future__ import annotations

import copy
from typing import Any, Dict

_DENSE = {
    "name": "qwen3-smoke", "family": "dense", "model_type": "qwen3", "head_dim": 16,
    "hidden_size": 64, "intermediate_size": 128, "max_position_embeddings": 512,
    "num_attention_heads": 4, "num_hidden_layers": 2, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000, "tie_word_embeddings": False,
    "vocab_size": 256,
    "port": {"name": "qwen3-smoke", "family": "dense", "num_layers": 2, "d_model": 64,
             "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
             "vocab_size": 256, "qk_norm": True, "rope_theta": 1000000.0, "rms_eps": 1e-6,
             "param_dtype": "float32", "activation_dtype": "float32"},
    "assumed": {"device_hbm_bytes": 1.2e6, "activation_headroom": 0.1, "page_tokens": 16,
                "engine": {"max_requests": 512}},
    "limits": {"max_logit_gap": 0.005},
}

_MOE = {
    "name": "deepseek-smoke", "family": "moe", "model_type": "deepseek",
    "first_k_dense_replace": 1, "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 512, "moe_intermediate_size": 32, "moe_layer_freq": 1,
    "n_routed_experts": 8, "n_shared_experts": 1, "norm_topk_prob": True,
    "num_attention_heads": 4,
    "num_experts_per_tok": 2, "num_hidden_layers": 3, "num_key_value_heads": 4,
    "rms_norm_eps": 1e-6, "rope_theta": 10000, "tie_word_embeddings": False,
    "vocab_size": 256,
    "port": {"name": "deepseek-smoke", "family": "moe", "num_layers": 3, "d_model": 64,
             "num_heads": 4, "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
             "vocab_size": 256, "qk_norm": False, "rope_theta": 10000.0, "rms_eps": 1e-6,
             "param_dtype": "float32", "activation_dtype": "float32",
             "moe": {"num_experts": 8, "top_k": 2, "expert_d_ff": 32, "num_shared_experts": 1,
                     "shared_d_ff": 32, "interleave": 1, "first_dense_layers": 1,
                     "first_dense_d_ff": 128, "capacity_factor": 1.0, "dispatch": "scatter"}},
    "assumed": {"device_hbm_bytes": 1.2e6, "activation_headroom": 0.1, "page_tokens": 16,
                "engine": {"max_requests": 512}, "capacity_factor": 1.0},
    "limits": {"mean_logit_gap": 0.001},
}

_CHAT = {
    "prompt": {"median": 24, "sigma": 0.6, "lo": 8, "hi": 64},
    "output": {"median": 8, "sigma": 0.7, "lo": 2, "hi": 24},
    "rate": 40.0, "first_wave": 120, "warmup_s": 0.1, "host_pool_share": 0.6,
    "sizes": {"count": 256, "seed": 7},
}

CELL = {"name": "smoke", "config": "smoke", "traffic": "smoke", "chips": 1}


def dense() -> Dict[str, Any]:
    return copy.deepcopy(_DENSE)


def moe() -> Dict[str, Any]:
    return copy.deepcopy(_MOE)


def chat(**kw) -> Dict[str, Any]:
    mix = copy.deepcopy(_CHAT)
    mix.update(kw)
    return mix
