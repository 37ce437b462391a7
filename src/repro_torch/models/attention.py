"""Attention over contiguous K/V, in plain torch (matmul + softmax), as the
JAX package leaves these to XLA.

* :func:`prefill_attention` — causal (optionally sliding-window) prefill
  attention: the flash prefill kernel (:mod:`repro_torch.kernels.flash_prefill`)
  by default, or :func:`chunked_attention` when asked for the plain version
  (oracles and tests).  Every dense and zamba2 prefill goes through it.
* :func:`chunked_attention` — the plain prefill attention, chunked over
  queries so the [Sq, Skv] score matrix is never materialised whole.
* :func:`decode_attention` — one-token decode over a contiguous per-sequence
  cache; the dense oracle's decode path and zamba2's shared-attention decode.
* :func:`write_kv` — write each row's new K/V at its own position (zamba2's
  ring buffer writes at ``lens % capacity``).
* :func:`prefix_attention` / :func:`suffix_attention_merge` — a prefix-cache
  hit's suffix prefill over a cached prefix gathered from the device pool,
  or over flash partials the host computed on its own prefix pages (plain
  einsums and softmax, as the reference writes them in jnp; products in the
  activation dtype, scores and the merge in float32).

The engine's device-row decode attention over the paged pool is the CUDA
kernel in :mod:`repro_torch.kernels.paged_decode`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_prefill import flash_prefill

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[..., KV, hd] -> [..., KV*q_per_kv, hd] (each kv head repeated)."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=-2)


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,  # [B, Skv, KV, hd]
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full (optionally causal / sliding-window) attention, chunked over Sq.

    ``q_offset`` is the absolute position of q[:, 0] relative to k[:, 0].
    The last chunk may be ragged (the reference needs ``Sq % q_chunk == 0``
    because its lengths are padded to power-of-two buckets; the port's are
    not).
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    q_per_kv = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    k = _repeat_kv(k, q_per_kv)  # [B, Skv, H, hd]
    v = _repeat_kv(v, q_per_kv)
    kv_pos = torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qi = q[:, c0:c0 + q_chunk]
        q_pos = q_offset + c0 + torch.arange(qi.shape[1], device=q.device)
        s = torch.einsum("bchd,bshd->bchs", qi, k).float() * scale
        mask = torch.ones((qi.shape[1], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bchs,bshd->bchd", p.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def prefill_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd]
    *,
    causal: bool = True,
    window: int = 0,
    impl: str = "kernel",
) -> torch.Tensor:
    """Prefill attention over the sequence itself.  ``impl="kernel"`` is the
    flash prefill kernel's wrapper (its plain version for CPU tensors, the
    CUDA kernel for CUDA tensors); ``impl="plain"`` is
    :func:`chunked_attention`, for oracles that must not depend on the
    kernel."""
    if impl == "kernel":
        return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window)
    if impl == "plain":
        return chunked_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown impl {impl!r}")


def decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_cache: torch.Tensor,  # [B, S, KV, hd] (already includes the new token)
    v_cache: torch.Tensor,
    lens: torch.Tensor,  # [B] int — number of valid tokens (incl. new one)
    *,
    window: int = 0,
) -> torch.Tensor:
    B, S, KV, hd = k_cache.shape
    q_per_kv = q.shape[1] // KV
    scale = 1.0 / math.sqrt(hd)
    kr = _repeat_kv(k_cache, q_per_kv)  # [B, S, H, hd]
    vr = _repeat_kv(v_cache, q_per_kv)
    s = torch.einsum("bhd,bshd->bhs", q, kr).float() * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < lens[:, None]
    if window:
        mask &= pos[None, :] >= (lens[:, None] - window)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(vr.dtype), vr)


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k_new: torch.Tensor,
             v_new: torch.Tensor, pos: torch.Tensor, rows=None) -> None:
    """cache [B, S, KV, hd]; new [B, KV, hd]; writes row b's new K/V at
    ``pos[b]`` (clipped to the cache) in place (the reference returns new
    caches; the port saves the copy), for the ``rows`` (indices) only when
    given."""
    S = cache_k.shape[1]
    if rows is None:
        rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    p = pos[rows].long().clamp(0, S - 1)
    cache_k[rows, p] = k_new[rows].to(cache_k.dtype)
    cache_v[rows, p] = v_new[rows].to(cache_v.dtype)


# ---------------------------------------------------------------------------
# suffix prefill over a cached prefix (prefix cache)
# ---------------------------------------------------------------------------


def _suffix_scores(q: torch.Tensor, kn: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal float32 scores of the suffix queries over the suffix keys
    [B, S, H, S]: query i sees keys 0..i."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bqhk", q, kn).float() * scale
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    return torch.where(causal[None, :, None, :], s, NEG_INF)


def prefix_attention(
    q: torch.Tensor,  # [B, S, H, hd] suffix queries
    k_pre: torch.Tensor,  # [B, T, KV, hd] cached prefix K, padded to T
    v_pre: torch.Tensor,
    prefix_lens: torch.Tensor,  # [B] valid prefix tokens per row
    k_new: torch.Tensor,  # [B, S, KV, hd] the suffix's own K/V
    v_new: torch.Tensor,
) -> torch.Tensor:
    """Attention of a partial prefill that starts at a nonzero KV offset:
    query i of row b sits at absolute position ``prefix_lens[b] + i`` and
    attends over the row's valid cached prefix plus the suffix causally, in
    one softmax over the concatenated scores (prefix padding masked).
    Returns [B, S, H, hd] in the activation dtype."""
    T = k_pre.shape[1]
    qpk = q.shape[2] // k_new.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kp, vp = _repeat_kv(k_pre, qpk), _repeat_kv(v_pre, qpk)
    kn, vn = _repeat_kv(k_new, qpk), _repeat_kv(v_new, qpk)
    s_pre = torch.einsum("bqhd,bkhd->bqhk", q, kp).float() * scale
    valid = torch.arange(T, device=q.device)[None, :] < prefix_lens.to(q.device)[:, None]
    s_pre = torch.where(valid[:, None, None, :], s_pre, NEG_INF)
    p = torch.softmax(torch.cat([s_pre, _suffix_scores(q, kn, scale)], dim=-1), dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p[..., :T].to(vp.dtype), vp)
    return o + torch.einsum("bqhk,bkhd->bqhd", p[..., T:].to(vn.dtype), vn)


def suffix_attention_merge(
    q: torch.Tensor,  # [B, S, H, hd] suffix queries
    k_new: torch.Tensor,  # [B, S, KV, hd] the suffix's own K/V
    v_new: torch.Tensor,
    pre_acc: torch.Tensor,  # [B, S, H, hd] prefix flash partials (host)
    pre_l: torch.Tensor,  # [B, S, H]
    pre_m: torch.Tensor,  # [B, S, H]; -1e30 marks rows with no prefix
) -> torch.Tensor:
    """The zero-copy host path of :func:`prefix_attention`: the host has
    computed flash partials ``(acc, l, m)`` over its in-place prefix pages;
    this computes the causal suffix attention on the card and merges the
    two by log-sum-exp, which is the joint softmax over [prefix, causal
    suffix].  Returns [B, S, H, hd] float32."""
    qpk = q.shape[2] // k_new.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kn, vn = _repeat_kv(k_new, qpk), _repeat_kv(v_new, qpk)
    s_new = _suffix_scores(q, kn, scale)
    m_new = s_new.amax(dim=-1)  # [B, S, H]; the diagonal keeps it finite
    e = torch.exp(s_new - m_new[..., None])
    l_new = e.sum(dim=-1)
    acc_new = torch.einsum("bqhk,bkhd->bqhd", e.to(vn.dtype), vn).float()
    m_tot = torch.maximum(pre_m, m_new)
    c_pre = torch.exp(pre_m - m_tot)  # 0 where there is no prefix
    c_new = torch.exp(m_new - m_tot)
    num = pre_acc * c_pre[..., None] + acc_new * c_new[..., None]
    den = pre_l * c_pre + l_new * c_new
    return num / torch.clamp(den, min=1e-30)[..., None]
