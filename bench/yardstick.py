"""The benchmark's own arithmetic: peaks, parameter counts, the device pool
rule, model FLOPs and the work of the two attention kernels.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``H100_PEAK_FLOPS`` / ``H100_HBM_BW``: ``src/repro_torch/roofline/hw.py``
  (``roofline/analysis.py`` reads them as ``PEAK_FLOPS`` / ``HBM_BW``), the
  published dense bf16 rate and HBM bandwidth of one H100 SXM.
* :func:`param_count`: ``src/repro_torch/models/api.py::_decoder_count``.
* :func:`device_pages`: ``src/repro_torch/serving/simulator.py::size_pools``.
* :func:`linear_flops_per_token`: ``src/repro_torch/roofline/analysis.py::
  model_flops`` (2 x active parameters a token), without the embedding
  lookup, and with the output head counted only where logits are computed.

Everything reads the configuration file's published keys (the Hugging Face
``config.json`` names), never the program's config objects.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple

H100_PEAK_FLOPS = 989e12  # dense bf16 / fp16, tensor cores
H100_HBM_BW = 3.35e12  # bytes/s
BF16_BYTES = 2


def dims(hf: Mapping) -> Tuple[int, int, int, int, int]:
    """(layers, d_model, query heads, kv heads, head_dim)."""
    H = hf["num_attention_heads"]
    hd = hf.get("head_dim") or hf["hidden_size"] // H
    return (hf["num_hidden_layers"], hf["hidden_size"], H,
            hf.get("num_key_value_heads", H), hd)


def is_moe_layer(hf: Mapping, i: int) -> bool:
    if not hf.get("n_routed_experts"):
        return False
    return i >= hf.get("first_k_dense_replace", 0) and (
        (i - hf.get("first_k_dense_replace", 0)) % hf.get("moe_layer_freq", 1) == 0)


def _layer_params(hf: Mapping, i: int, active: bool) -> int:
    L, d, H, KV, hd = dims(hf)
    n = 2 * d + d * H * hd + 2 * d * KV * hd + H * hd * d
    if hf.get("model_type") == "qwen3":
        n += 2 * hd  # q_norm, k_norm
    if is_moe_layer(hf, i):
        E, ff = hf["n_routed_experts"], hf["moe_intermediate_size"]
        routed = 3 * d * ff * (hf["num_experts_per_tok"] if active else E)
        n += d * E + routed + 3 * d * ff * hf.get("n_shared_experts", 0)
    else:
        n += 3 * d * hf["intermediate_size"]
    return n


def embedding_params(hf: Mapping) -> int:
    d, V = hf["hidden_size"], hf["vocab_size"]
    return V * d * (1 if hf.get("tie_word_embeddings") else 2)


def param_count(hf: Mapping) -> int:
    """Every parameter the served model holds (embeddings, final norm,
    layers): the port's ``param_count``."""
    L = hf["num_hidden_layers"]
    return (embedding_params(hf) + hf["hidden_size"]
            + sum(_layer_params(hf, i, False) for i in range(L)))


def device_pages(hf: Mapping, assumed: Mapping) -> int:
    """The device KV pool in pages: the usable share of the card's memory,
    less the bf16 weights, over one page of bf16 KV (``size_pools``)."""
    L, d, H, KV, hd = dims(hf)
    page = assumed["page_tokens"]
    usable = assumed["device_hbm_bytes"] * (1 - assumed["activation_headroom"])
    usable -= param_count(hf) * BF16_BYTES
    return max(int(usable / (kv_bytes_per_token(hf) * page)), 0)


def kv_bytes_per_token(hf: Mapping) -> int:
    L, d, H, KV, hd = dims(hf)
    return 2 * L * KV * hd * BF16_BYTES


def linear_flops_per_token(hf: Mapping) -> float:
    """2 x the parameters one token's matmuls run through, the routed
    experts at their top-k share; neither embedding table counted."""
    L = hf["num_hidden_layers"]
    return 2.0 * sum(_layer_params(hf, i, True) for i in range(L))


def head_flops(hf: Mapping) -> float:
    """The output head for one row of logits."""
    return 2.0 * hf["hidden_size"] * hf["vocab_size"]


def attn_pair_flops(hf: Mapping) -> float:
    """QK^T and PV of one query-key pair over every layer and head."""
    L, d, H, KV, hd = dims(hf)
    return 4.0 * L * H * hd


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


# ---------------------------------------------------------------------------
# The attention kernels' work.  One call runs one layer; every layer's call
# does the same work, so a step's bound is layers x one call's.  Each input
# byte is counted once and each output byte once; operations are the
# query-key pairs the inputs need (a padded row or position adds none).
# ---------------------------------------------------------------------------


def paged_decode_call(hf: Mapping, ctx_lens: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K1 call over device rows attending over
    ``ctx_lens`` tokens each: q and the output once, each KV head's K and V
    pages once (GQA reads them once for its query group)."""
    L, d, H, KV, hd = dims(hf)
    lens = list(ctx_lens)
    pairs = sum(lens)
    flops = 4.0 * H * hd * pairs
    nbytes = BF16_BYTES * (2 * KV * hd * pairs + 2 * H * hd * len(lens))
    return flops, nbytes


def flash_prefill_call(hf: Mapping, seq_lens: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K2 call over causal rows of ``seq_lens``
    tokens: q, k, v read and the output written once."""
    L, d, H, KV, hd = dims(hf)
    lens = list(seq_lens)
    flops = 4.0 * H * hd * sum(causal_pairs(n) for n in lens)
    nbytes = BF16_BYTES * (2 * H + 2 * KV) * hd * sum(lens)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one H100 could take: the larger of the two terms."""
    return max(flops / H100_PEAK_FLOPS, nbytes / H100_HBM_BW)
