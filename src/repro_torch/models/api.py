"""Model factory of the port.

:class:`~repro_torch.models.transformer.DenseLM` serves the dense, moe and
vlm families, :class:`~repro_torch.models.rwkv6.RWKV6LM` the ssm family,
:class:`~repro_torch.models.zamba2.Zamba2LM` the hybrid family and
:class:`~repro_torch.models.encdec.EncDecLM` the audio (encoder-decoder)
family.  :func:`param_count` and :func:`active_param_count` count a
config's parameters from its shapes alone, as the reference counts its
parameter tree.
"""

from __future__ import annotations

from repro_torch.config import ArchConfig

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def get_model(cfg: ArchConfig, *, device=None):
    """The model of ``cfg``'s family on ``device`` (the card unless
    ``device="cpu"``), weights uninitialised."""
    _check_family(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import RWKV6LM

        return RWKV6LM(cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import Zamba2LM

        return Zamba2LM(cfg, device=device)
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, device=device)
    from repro_torch.models.transformer import DenseLM

    return DenseLM(cfg, device=device)


def _attn_count(cfg: ArchConfig) -> int:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * H * hd + 2 * d * KV * hd + H * hd * d + (2 * hd if cfg.qk_norm else 0)


def _rwkv6_count(cfg: ArchConfig) -> int:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    HN = cfg.num_heads * cfg.ssm.head_dim
    mr, dr = min(32, d // 4), min(64, d // 4)  # rwkv6.MAA_RANK, DECAY_RANK
    per_layer = (2 * d + d + 5 * d + d * 5 * mr + 5 * mr * d + d + d * dr + dr * d
                 + HN + 4 * d * HN + HN * d + 2 * HN + 2 * d + d * ff + ff * d + d * d)
    return 2 * V * d + 2 * d + cfg.num_layers * per_layer


def _zamba2_count(cfg: ArchConfig) -> int:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    s = cfg.ssm
    di = s.expand * d
    H, P, N = di // s.head_dim, s.head_dim, s.state_dim
    conv_dim = di + 2 * N
    mamba = (d + 2 * d * H * P + 2 * d * N + d * H + 3 * H + conv_dim * s.conv_kernel
             + conv_dim + H * P + H * P * d)
    shared = 2 * d + 2 * d * d + d + _attn_count(cfg) + d + 3 * d * ff + d * d
    return 2 * V * d + d + shared + cfg.num_layers * mamba


def _encdec_count(cfg: ArchConfig) -> int:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    enc_layer = 2 * d + _attn_count(cfg) + 3 * d * ff
    dec_layer = enc_layer + d + _attn_count(cfg)
    return (2 * V * d + d * d + 2 * d + cfg.encdec.encoder_layers * enc_layer
            + cfg.num_layers * dec_layer)


def _decoder_count(cfg: ArchConfig) -> int:
    """DenseLM (dense / moe / vlm): embeddings, final norm, and each layer
    of the reference's pattern (``dense0`` at ``first_dense_d_ff``, ``moe``
    with its float32 router, routed and shared experts)."""
    from repro_torch.models.transformer import layer_pattern

    d = cfg.d_model
    prefix, group, n_groups = layer_pattern(cfg)

    def layer(kind: str) -> int:
        n = 2 * d + _attn_count(cfg)
        if kind == "moe":
            moe = cfg.moe
            n += d * moe.num_experts + 3 * moe.num_experts * d * moe.expert_d_ff
            if moe.num_shared_experts:
                n += 3 * d * moe.shared_d_ff * moe.num_shared_experts
            return n
        f = cfg.moe.first_dense_d_ff if kind == "dense0" and cfg.moe else cfg.d_ff
        return n + 3 * d * f

    total = cfg.vocab_size * d + d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    return (total + sum(layer(k) for k in prefix)
            + n_groups * sum(layer(k) for k in group))


def param_count(cfg: ArchConfig) -> int:
    """Parameter count of the model ``get_model(cfg)`` builds, from shapes
    alone (no allocation)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return _rwkv6_count(cfg)
    if cfg.family == "hybrid":
        return _zamba2_count(cfg)
    if cfg.family == "audio":
        return _encdec_count(cfg)
    return _decoder_count(cfg)


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters one token runs through: the reference's rule, each routed
    expert leaf (``moe.w_gate``/``w_up``/``w_down``, not the shared ones)
    counted at ``n * top_k // num_experts``, per stacked leaf as the
    reference's tree holds it."""
    total = param_count(cfg)
    if cfg.moe is None or cfg.family not in ("dense", "moe", "vlm"):
        return total
    from repro_torch.models.transformer import layer_pattern

    moe = cfg.moe
    prefix, group, n_groups = layer_pattern(cfg)
    leaf = moe.num_experts * cfg.d_model * moe.expert_d_ff  # one layer's w_gate

    def active(n: int) -> int:
        return n * moe.top_k // moe.num_experts

    for kind in prefix:  # prefix layers are leaves of their own
        if kind == "moe":
            total += 3 * (active(leaf) - leaf)
    for kind in group:  # group leaves are stacked over the groups
        if kind == "moe":
            total += 3 * (active(n_groups * leaf) - n_groups * leaf)
    return total
