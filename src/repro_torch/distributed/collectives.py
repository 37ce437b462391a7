"""Gradient-compression collectives, the port of the JAX package's
``distributed/collectives.py``.

* :func:`int8_roundtrip` — quantise then dequantise each leaf with a
  per-tensor max-abs scale: the error model of the int8 all-reduce, which
  the single-device trainer applies to its gradients.

``int8_allreduce_mean`` reduces over a process group; multi-device
training is ROADMAP P16b.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 g -> (int8 codes ``round(g / scale)`` clipped to ±127, round
    half to even as ``jnp.round``; scale ``max|g| / 127 + 1e-12``)."""
    scale = g.abs().max() / 127.0 + 1e-12
    return torch.round(g / scale).clamp(-127, 127).to(torch.int8), scale


@torch.no_grad()
def int8_roundtrip(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Quantise-dequantise each leaf, back in its own dtype."""
    out = {}
    for k, g in tree.items():
        q, scale = _quantise(g.float())
        out[k] = (q.float() * scale).to(g.dtype)
    return out
