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
* :func:`decode_attention_blocksharded` — split-K decode on a mesh whose
  ``model`` axis shards the KV sequence (``kv_shard_mode="blocks"``): each
  rank attends over its own KV blocks, and the partials merge by
  log-sum-exp across the model axis.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import current_context, mesh_sizes, shard, spec_placements
from repro_torch.kernels.flash_prefill import flash_prefill

NEG_INF = -1e30


def _heads_sharded() -> bool:
    ctx = current_context()
    return ctx is not None and ctx.rules.get("heads") is not None


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
    not).  On DTensors each rank attends over its own block
    (:func:`_attention_blocks`, where the reference's layout
    constraints on k, v, the scores and the output sit): below that branch
    every tensor is plain.
    """
    if isinstance(q, DTensor):
        return _attention_blocks(chunked_attention, q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, q_offset=q_offset)
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


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: DTensor
    views a local gradient as if it were contiguous, and an einsum's is not."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attention_blocks(attend, q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """``attend`` (:func:`chunked_attention` or the flash prefill kernel's
    wrapper) on a mesh.  Attention is independent per batch row and per
    head, so each rank attends over its own block as local tensors: its
    batch rows, and under a heads rule its block of the query heads against
    the KV heads they read (the KV heads gathered over the model axis,
    their gradient a partial sum over it).  DTensor's own einsum here merges
    the batch and head dims, sharded over two mesh dims, which the sharding
    propagation of torch 2.11 refuses."""
    mesh = q.device_mesh
    heads = _heads_sharded()
    q = shard(q, "batch", None, "heads" if heads else None, None)
    hdims = [i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2]
    ql = q.to_local()
    if hdims and k.shape[2] == q.shape[2]:
        # K/V projected one per query head (``transformer.kv_follow_queries``):
        # laid out as q, each rank holds the heads its queries read
        kl, vl = (_ContiguousGrad.apply(shard(t, "batch", None, "heads", None).to_local())
                  for t in (k, v))
        o = attend(ql, kl, vl, **kw)
        return DTensor.from_local(o, mesh, q.placements, run_check=False, shape=q.shape,
                                  stride=torch.empty(q.shape, device="meta").stride())
    k, v = (shard(t, "batch", None, None, None) for t in (k, v))
    grad = [Partial() if i in hdims else p for i, p in enumerate(k.placements)]
    kl, vl = (t.to_local(grad_placements=grad) for t in (k, v))
    if hdims:  # this rank's block of heads (torch.chunk's blocks)
        d = hdims[0]
        H, Hl = q.shape[2], ql.shape[2]
        qpk = H // kl.shape[2]
        h0 = mesh.get_local_rank(d) * -(-H // mesh.size(d))
        if h0 % qpk == 0 and Hl % qpk == 0:  # whole groups: their own KV heads
            kl, vl = (t[:, :, h0 // qpk:(h0 + Hl) // qpk] for t in (kl, vl))
        else:
            kl, vl = (_repeat_kv(t, qpk)[:, :, h0:h0 + Hl] for t in (kl, vl))
    # torch.chunk's blocks leave the last ranks no head when the heads do not
    # divide the axis (40 on 16: thirteen of 3, one of 1, two of none); such a
    # rank's empty blocks stay in its graph (their sums are 0), so K/V get
    # its zero term of their gradient
    o = attend(ql, kl, vl, **kw) if ql.shape[2] else ql + kl.sum() + vl.sum()
    # the global shape given: heads that do not divide the axis leave the
    # ranks blocks of unequal size
    return DTensor.from_local(o, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=torch.empty(q.shape, device="meta").stride())


def _flash(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=window)


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
    CUDA kernel for CUDA tensors; on a mesh, on each rank's block);
    ``impl="plain"`` is :func:`chunked_attention`, for oracles that must not
    depend on the kernel."""
    if impl == "kernel":
        if isinstance(q, DTensor):
            return _attention_blocks(_flash, q, k, v, causal=causal, window=window)
        return _flash(q, k, v, causal=causal, window=window)
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
    if isinstance(q, DTensor):
        return _decode_blocks(q, k_cache, v_cache, lens, window)
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


def _decode_blocks(q: DTensor, k_cache, v_cache, lens, window: int) -> DTensor:
    """:func:`decode_attention` on a mesh (inference only), each rank over its
    own block: its batch rows and, under a heads rule, its block of query
    heads against the KV heads they read, from a cache laid out by batch
    and, where they divide the model axis, by KV heads (a cache sharded
    along its sequence takes :func:`decode_attention_blocksharded`)."""
    ctx = current_context()
    mesh = q.device_mesh
    heads = _heads_sharded() and q.shape[1] % mesh_sizes(mesh).get("model", 1) == 0
    q = shard(q, "batch", "heads" if heads else None, None)
    H = q.shape[1]

    def block(t, *logical):
        return (t if isinstance(t, DTensor) else ctx.distribute(t, logical))

    k, v = (block(t, "batch", None, None, None) for t in (k_cache, v_cache))
    if any(p.is_shard(1) for p in k.placements):
        raise ValueError("decode_attention takes a cache whose sequence is whole on each rank")
    ql = q.to_local()
    kv_split = any(p.is_shard(2) for p in k.placements)
    if not kv_split:
        k, v = (shard(t, "batch", None, None, None) for t in (k, v))
    kl, vl = k.to_local(), v.to_local()
    if heads and not kv_split and ql.shape[1] < H:  # this rank's block of query heads
        d = [i for i, p in enumerate(q.placements) if p.is_shard(1)][0]
        Hl, qpk = ql.shape[1], H // kl.shape[2]
        h0 = mesh.get_local_rank(d) * -(-H // mesh.size(d))
        if h0 % qpk == 0 and Hl % qpk == 0:
            kl, vl = (t[:, :, h0 // qpk:(h0 + Hl) // qpk] for t in (kl, vl))
        else:
            kl, vl = (_repeat_kv(t, qpk)[:, :, h0:h0 + Hl] for t in (kl, vl))
    ll = block(lens, "batch")
    ll = shard(ll, "batch").to_local()
    o = decode_attention(ql, kl, vl, ll, window=window)
    return DTensor.from_local(o, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=torch.empty(q.shape, device="meta").stride())


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k_new: torch.Tensor,
             v_new: torch.Tensor, pos: torch.Tensor, rows=None) -> None:
    """cache [B, S, KV, hd]; new [B, KV, hd]; writes row b's new K/V at
    ``pos[b]`` (clipped to the cache) in place (the reference returns new
    caches; the port saves the copy), for the ``rows`` (indices) only when
    given."""
    if isinstance(cache_k, DTensor):
        return _write_kv_blocks(cache_k, cache_v, k_new, v_new, pos, rows)
    S = cache_k.shape[1]
    if rows is None:
        rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    p = pos[rows].long().clamp(0, S - 1)
    cache_k[rows, p] = k_new[rows].to(cache_k.dtype)
    cache_v[rows, p] = v_new[rows].to(cache_v.dtype)


def _write_kv_blocks(cache_k: DTensor, cache_v: DTensor, k_new, v_new, pos, rows) -> None:
    """:func:`write_kv` on a mesh, into a cache whose batch and KV-head dims
    may be sharded (not its sequence: that is
    :func:`decode_attention_blocksharded`'s): each rank writes its own rows'
    K/V heads into its block, the new K/V laid out as the cache and the
    positions as its batch."""
    if rows is not None:
        raise NotImplementedError("a row subset is not written on a mesh")
    if any(p.is_partial() for p in cache_k.placements + cache_v.placements):
        # each rank's term would take the new value (sharding.reduce_partials)
        raise ValueError("write_kv takes a cache that holds no partial sum")
    mesh = cache_k.device_mesh
    if any(p.is_shard(1) for p in cache_k.placements):
        raise ValueError("write_kv takes a cache whose sequence is whole on each rank")
    new_pl = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate()
              for p in cache_k.placements]
    pos_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in cache_k.placements]
    ctx = current_context()

    def lay(x, pl):
        if isinstance(x, DTensor):
            return x if list(x.placements) == pl else x.redistribute(mesh, pl)
        return ctx.distribute_placements(x, pl)

    write_kv(cache_k.to_local(), cache_v.to_local(), lay(k_new, new_pl).to_local(),
             lay(v_new, new_pl).to_local(), lay(pos, pos_pl).to_local())


# ---------------------------------------------------------------------------
# Split-K decode attention, KV sequence sharded over the "model" axis
# ---------------------------------------------------------------------------


def _partial_flash(q, k_local, v_local, valid, scale):
    """Unnormalised local attention: (acc [B, H, hd] float32, l [B, H],
    m [B, H])."""
    s = torch.einsum("bhd,bshd->bhs", q, k_local).float() * scale
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    # a rank with no valid key keeps m finite so exp() stays defined
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    e = torch.where(valid[:, None, :], torch.exp(s - m_safe[..., None]), 0.0)
    acc = torch.einsum("bhs,bshd->bhd", e.to(v_local.dtype), v_local).float()
    return acc, e.sum(dim=-1), m_safe


def decode_attention_blocksharded(
    q: torch.Tensor,  # [B, H, hd]
    k_cache: torch.Tensor,  # [B, S, KV, hd]; S sharded over "model"
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, KV, hd], the token to insert at position lens
    v_new: torch.Tensor,
    lens: torch.Tensor,  # [B] int, tokens valid BEFORE the insert
    *,
    window: int = 0,
):
    """Insert (k_new, v_new) at position ``lens`` and attend over ``lens +
    1`` keys, the KV sequence sharded over the ``model`` mesh axis: each
    rank writes the rows whose position falls in its block, computes flash
    partials over its block, and the partials merge by log-sum-exp (an
    all-reduce MAX, then SUMs, over the model axis): split-K flash decoding
    across cards.  Inputs are DTensors or full tensors (the same on every
    rank); the caches are laid out (batch, "model") and written in place.
    Returns (out [B, H, hd] replicated over model, k_cache, v_cache).  With
    no context on a mesh with a ``model`` axis: the contiguous decode."""
    ctx = current_context()
    if ctx is None or not ctx.distributed or "model" not in ctx.mesh.mesh_dim_names:
        write_kv(k_cache, v_cache, k_new, v_new, lens)
        return decode_attention(q, k_cache, v_cache, lens + 1, window=window), k_cache, v_cache

    mesh = ctx.mesh
    names = mesh.mesh_dim_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    bspec = (batch[0] if len(batch) == 1 else batch) if batch else None

    def lay(x, *rest):
        pl = spec_placements((bspec,) + rest, mesh)
        if isinstance(x, DTensor):
            x = x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        else:
            x = ctx.distribute_placements(x, pl)
        return x

    qd, knd, vnd = (lay(t, None, None) for t in (q, k_new, v_new))
    lensd = lay(lens)
    kcd, vcd = (lay(t, "model", None, None) for t in (k_cache, v_cache))
    ql, kn, vn, ln, kc, vc = (t.to_local() for t in (qd, knd, vnd, lensd, kcd, vcd))
    B, S, KV, hd = k_cache.shape
    local_S = S // mesh_sizes(mesh)["model"]
    offset = mesh.get_local_rank("model") * local_S
    # write the new token into the owning rank's block (a row this rank does
    # not own rewrites one of its slots with the value it holds: no mask
    # selects rows, so the write's shapes do not depend on the data)
    local_pos = ln.long() - offset
    owned = ((local_pos >= 0) & (local_pos < local_S))[:, None, None]
    rows = torch.arange(kc.shape[0], device=kc.device)
    pos = local_pos.clamp(0, local_S - 1)
    kc[rows, pos] = torch.where(owned, kn.to(kc.dtype), kc[rows, pos])
    vc[rows, pos] = torch.where(owned, vn.to(vc.dtype), vc[rows, pos])
    # partial attention over the local block
    new_lens = ln.long() + 1
    kv_pos = offset + torch.arange(local_S, device=kc.device)
    valid = kv_pos[None, :] < new_lens[:, None]
    if window:
        valid &= kv_pos[None, :] >= (new_lens[:, None] - window)
    qpk = ql.shape[1] // KV
    acc, l, m = _partial_flash(ql, _repeat_kv(kc, qpk), _repeat_kv(vc, qpk), valid,
                               1.0 / math.sqrt(hd))
    # combine across the model axis, log-sum-exp weighted
    group = mesh.get_group("model")
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    num = acc * corr[..., None]
    den = l * corr
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(ql.dtype)
    return (DTensor.from_local(out, mesh, qd.placements, run_check=False), kcd, vcd)


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
