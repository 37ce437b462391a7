"""Plain PyTorch version of paged GQA decode attention: the same function as
the CUDA kernel in ``csrc/paged_decode.cu`` and the JAX package's
``paged_decode_ref``.  The wrapper uses it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel to it on the card."""

from __future__ import annotations

import math

import torch


def paged_decode_ref(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, page, KV, hd]
    v_pages: torch.Tensor,  # [P, page, KV, hd]
    block_tables: torch.Tensor,  # [B, maxp] int32 (dead entries must be valid page ids)
    lens: torch.Tensor,  # [B] int32 — tokens valid in the cache (incl. current)
) -> torch.Tensor:
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    maxp = block_tables.shape[1]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, maxp * page, KV, hd).repeat_interleave(qpk, dim=2)
    v = v_pages[idx].reshape(B, maxp * page, KV, hd).repeat_interleave(qpk, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q, k).float() * scale
    pos = torch.arange(maxp * page, device=q.device)
    mask = (pos[None, :] < lens.to(q.device)[:, None])[:, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhs,bshd->bhd", p.to(v.dtype), v)
