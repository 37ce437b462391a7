"""Model factory of the port.

The dense family (:class:`~repro_torch.models.transformer.DenseLM`), the ssm
family (:class:`~repro_torch.models.rwkv6.RWKV6LM`) and the hybrid family
(:class:`~repro_torch.models.zamba2.Zamba2LM`) are ported; every other family
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from repro_torch.config import ArchConfig

_PENDING = {
    "moe": "ROADMAP P11",
    "vlm": "ROADMAP P11",
    "audio": "ROADMAP P12",
}
_PORTED = ("dense", "ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        item = _PENDING.get(cfg.family)
        if item is None:
            raise ValueError(f"unknown family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({item})")


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


def param_count(cfg: ArchConfig) -> int:
    """Parameter count of the model ``get_model(cfg)`` builds, from shapes
    alone (no allocation)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return _rwkv6_count(cfg)
    if cfg.family == "hybrid":
        return _zamba2_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    per_layer = 2 * d + _attn_count(cfg) + 3 * d * f
    total = cfg.vocab_size * d + d + cfg.num_layers * per_layer
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    return total
