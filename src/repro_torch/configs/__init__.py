"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published config; ``get_smoke_config(name)``
returns a reduced same-family variant for CPU smoke tests (small layers/width,
few experts, tiny vocab).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.config import ArchConfig

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_0_6b
from repro_torch.configs.qwen3_14b import CONFIG as _qwen3_14b
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.yi_9b import CONFIG as _yi_9b
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6_7b
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2_1b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2_7b

_REGISTRY: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _qwen3_0_6b,
        _qwen3_14b,
        _qwen3_32b,
        _yi_9b,
        _rwkv6_7b,
        _deepseek_moe_16b,
        _llama4,
        _internvl2_1b,
        _seamless,
        _zamba2_7b,
    )
}

ARCH_NAMES: List[str] = sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}") from None


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    from repro_torch.configs.smoke import reduce_config

    return reduce_config(get_config(name))
