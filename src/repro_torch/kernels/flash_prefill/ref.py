"""Plain PyTorch version of causal (optionally sliding-window) GQA prefill
attention: the same function as the CUDA kernel in ``csrc/flash_prefill.cu``
and the JAX package's ``flash_prefill_ref``.  It is the port's
``models/attention.py::chunked_attention`` (queries in chunks, the whole key
range at once).  The wrapper uses it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel to it on the card."""

from __future__ import annotations

import torch


def flash_prefill_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd]
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    # imported here: models.attention imports this package's wrapper
    from repro_torch.models.attention import chunked_attention

    return chunked_attention(q, k, v, causal=causal, window=window)
