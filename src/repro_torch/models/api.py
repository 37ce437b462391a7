"""Model factory of the port.

Only the dense family is ported; every other family raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from repro_torch.config import ArchConfig

_PENDING = {
    "moe": "ROADMAP P11",
    "vlm": "ROADMAP P11",
    "ssm": "ROADMAP P12",
    "hybrid": "ROADMAP P12",
    "audio": "ROADMAP P12",
}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        item = _PENDING.get(cfg.family)
        if item is None:
            raise ValueError(f"unknown family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({item})")


def get_model(cfg: ArchConfig, *, device=None):
    """A :class:`~repro_torch.models.transformer.DenseLM` for ``cfg`` on
    ``device`` (the card unless ``device="cpu"``), weights uninitialised."""
    _check_family(cfg)
    from repro_torch.models.transformer import DenseLM

    return DenseLM(cfg, device=device)


def param_count(cfg: ArchConfig) -> int:
    """Parameter count of the model ``get_model(cfg)`` builds, from shapes
    alone (no allocation)."""
    _check_family(cfg)
    d, H, KV, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_layer = 2 * d + d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    if cfg.qk_norm:
        per_layer += 2 * hd
    total = cfg.vocab_size * d + d + cfg.num_layers * per_layer
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    return total
