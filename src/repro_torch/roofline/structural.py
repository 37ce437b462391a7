"""Structural (closed-form) per-chip HBM traffic model, the port of the JAX
package's ``roofline/structural.py`` (the same accounting, number for
number).

The counter's traffic (``roofline/opcount.py``) is an upper bound: it
charges every op's operands and result, as if nothing stayed in cache or
in registers between ops.  The roofline's MEMORY term uses this closed
form instead; the counted number is kept in the artifacts as an
upper-bound cross-check.  Shard counts come from ``sharding.mesh_sizes``,
so a ``DeviceMesh`` and a ``StubMesh`` serve alike.

Accounting (bf16 = 2 bytes unless stated):

train (per optimizer step, per chip):
  weights   : P/s_w × 2B × accum × 4     (fwd read + remat re-read + 2 bwd)
  grads     : P/s_w × 2B × 3             (write + read + reduce r/w, bf16)
  optimizer : P/s_o × 4B × 6             (m,v read+write + param read+write)
  residuals : L × T_micro × d × 2B × 2 × accum / s_seq   (stack w + r)
  logits    : T × V/s_v × 4B × 2         (chunked xent, written + read once)
  attention : L × T × (6 q/k/v/o io) × H·hd × 2B / s_h × accum_total

prefill: weights ×1, activations ×1, KV write, logits last-position only.
decode : weights ×1 + FULL KV read + one-token KV write + small activations.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import mesh_sizes


def _shards(mesh, *axes: str) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def structural_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     grad_accum: int = 1, seq_parallel: bool = True) -> Dict[str, float]:
    """Per-chip HBM bytes for one step of this cell."""
    s_model = _shards(mesh, "model")
    s_data = _shards(mesh, "data", "pod")
    chips = s_model * s_data
    P = cfg.param_count()
    P_active = cfg.active_param_count()
    L = cfg.num_layers
    d = cfg.d_model
    V = cfg.vocab_size
    H, hd = cfg.num_heads, cfg.head_dim
    B, S = shape.global_batch, shape.seq_len
    tokens_per_chip = B * S / s_data if shape.kind != "decode" else B / s_data

    out: Dict[str, float] = {}
    if shape.kind == "train":
        micro_tokens = tokens_per_chip / max(grad_accum, 1)
        s_seq = s_model if seq_parallel else 1
        out["weights"] = P / s_model * 2 * grad_accum * 4
        out["grads"] = P / s_model * 2 * 3
        out["optimizer"] = P / chips * 4 * 6  # ZeRO: m,v sharded over chips
        out["residual_stack"] = L * micro_tokens * d * 2 * 2 * grad_accum / s_seq
        out["logits"] = tokens_per_chip * (V / s_model) * 4 * 2
        out["attention_io"] = L * tokens_per_chip * 6 * H * hd * 2 / s_model
    elif shape.kind == "prefill":
        out["weights"] = P_active / s_model * 2
        out["activations"] = L * tokens_per_chip * d * 2 * 2
        out["kv_write"] = cfg.kv_bytes_per_token() * tokens_per_chip / s_model
        out["logits"] = B / s_data * (V / s_model) * 4 * 2
    else:  # decode: one token per sequence over a seq_len-deep cache
        kv_tok = cfg.kv_bytes_per_token()
        if cfg.kv_cache_dtype == "int8":
            # 1 B/elem + one f32 scale per (token, layer, kv head)
            kv_tok = cfg.kv_bytes_per_token(1) + \
                2 * cfg.num_attention_layers * cfg.num_kv_heads * 4
        kv_read = kv_tok * S * B / chips
        out["weights"] = P_active / s_model * 2
        out["kv_read"] = kv_read
        out["kv_write"] = kv_tok * B / chips
        out["activations"] = L * (B / s_data) * d * 2 * 4
        out["logits"] = B / s_data * (V / s_model) * 4 * 2
    out["total"] = sum(out.values())
    return out
