"""Decoder-only LM for the dense, moe and vlm families (qwen3-*, yi-9b, the
paper's LLaMa models, deepseek-moe-16b, llama4-maverick, internvl2-1b).

Parameters live in an ``nn.Module`` tree whose leaves keep the JAX
package's layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, ``w_gate [d, f]``,
``moe.w_gate [E, d, ff]``) so :mod:`repro_torch.models.bridge` maps one onto
the other leaf for leaf.  Layers are an ``nn.ModuleList`` instead of the
reference's ``vmap``-stacked groups; their kinds follow the reference's
pattern (:func:`layer_pattern`: ``first_dense_layers`` of kind ``dense0``,
then groups of ``["moe"] + ["dense"] * (interleave - 1)``), and every FFN
goes through :func:`mlp_apply`.  The serve entry points are
:meth:`DenseLM.prefill` (cold prefill, per-layer K/V out; a vlm's patch
embeddings replace the first positions), :meth:`DenseLM.decode` (one token
over a contiguous cache — the dense oracle the paged engine is held to;
with ``kv_cache_dtype="int8"`` over the quantised cache) and, for
prefix-cache hits, :meth:`DenseLM.prefill_with_prefix` (the suffix over a
cached prefix gathered from the device pool) and
:meth:`DenseLM.prefill_with_host_prefix` (the suffix over a prefix the host
serves in place, through a per-layer callback).  Training calls
:meth:`DenseLM.loss`: the plain attention (the kernels have no backward),
the reference's remat unit and its chunked cross entropy plus the MoE
load-balance loss.

Tensor-parallel serving (gather-TP, :mod:`repro_torch.distributed.sharding`)
passes ``shards``: per layer, one dict per shard of its column slices
(``wq``/``wk``/``wv`` over its heads, ``w_gate``/``w_up`` over its d_ff
columns, the replicated qk-norm scales), each on its shard's device.  The
model keeps the reference's two seams: each shard's attention output is
concatenated on the head axis before the replicated ``wo``, and its SwiGLU
hidden on d_ff before the replicated ``w_down``; both on this model's
device, where the replicated layers run once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import (current_context, model_axis_size, reduce_partials,
                                              shard, tp_allgather)
from repro_torch.models import attention as attn_lib
from repro_torch.models.api import token_specs
from repro_torch.models.layers import (
    AUX_LOSS_WEIGHT,
    PREFILL_MIN_ROWS,
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    flat_axes,
    init_mlp,
    logits_last,
    maybe_remat,
    mlp_params,
    param,
    rms_norm,
    rows_matmul,
    rows_out,
    serving,
    softmax_xent,
    swiglu_apply,
    swiglu_hidden,
    swiglu_logical_axes,
    tag_sp_gathered,
    zeros_cache,
)
from repro_torch.models.moe import MoE, moe_apply, moe_logical_axes

Cache = Dict[str, torch.Tensor]
# per layer, one dict of column slices per tensor-parallel shard
Shards = List[Dict[str, torch.Tensor]]


def kv_follow_queries(cfg: ArchConfig) -> bool:
    """True on a mesh whose model axis shards the query heads but not the
    KV heads.  There each rank projects only the KV heads its own query
    heads read, laid out as the queries (one K/V head per query head), as
    GSPMD slices the reference's replicated K/V weights to the heads a
    partition reads; DTensor would have every rank project every KV head."""
    ctx = current_context()
    m = model_axis_size()
    return (ctx is not None and ctx.distributed and m > 1 and cfg.num_kv_heads < cfg.num_heads
            and ctx.rules.get("heads") is not None and ctx.rules.get("kv_heads") is None
            and cfg.num_heads % m == 0)


def _per_query_head(w: DTensor, H: int) -> DTensor:
    """A K/V weight [d, KV, hd], replicated over the model axis, as [d, H,
    hd] with one column block per query head, sharded over the model axis
    like the query heads: each rank builds its own block from its copy (no
    communication).  Its gradient comes back reduced over the other mesh
    dims and a partial sum over the model axis (each rank's block holds
    only the gradient of the KV heads its query heads read)."""
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.size(names.index("model"))
    wl = w.to_local(grad_placements=[Partial() if n == "model" else Replicate()
                                     for n in names])
    h0 = mesh.get_local_rank("model") * (H // m)
    block = wl.repeat_interleave(H // w.shape[1], dim=1)[:, h0:h0 + H // m]
    return DTensor.from_local(block, mesh, [Shard(1) if n == "model" else Replicate()
                                            for n in names], run_check=False)


def kv_heads(t: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """K or V projected one per query head (``kv_follow``) back to one per
    KV head, whole over the model axis (a gather of the heads)."""
    t = shard(t, "batch", *[None] * (t.ndim - 1))
    return t[:, :, ::cfg.q_per_kv]


def project_qkv(p, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                min_rows: int = 0, kv_follow: bool = False):
    """h: [B, S, d]; positions: [B, S] or [S].  Returns roped q [B,S,H,hd],
    k and v [B,S,KV,hd], where H and KV are the head counts of ``p``'s
    columns: a tensor-parallel shard passes its slice (H/tp, KV/tp).  A
    prefill passes ``min_rows`` (``layers.rows_matmul``).  With
    ``kv_follow`` (:func:`kv_follow_queries`) k and v come one per query
    head, [B,S,H,hd], laid out as q."""
    B, S, d = h.shape
    H, KV, hd = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
    wk, wv = p["wk"], p["wv"]
    if kv_follow:
        wk, wv = _per_query_head(wk, H), _per_query_head(wv, H)
        KV = H
    q = rows_matmul(h, p["wq"].reshape(d, -1), min_rows).view(B, S, H, hd)
    k = rows_matmul(h, wk.reshape(d, -1), min_rows).view(B, S, KV, hd)
    v = rows_matmul(h, wv.reshape(d, -1), min_rows).view(B, S, KV, hd)
    q, k, v = tag_sp_gathered(q, k, v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if positions.ndim == 1:
        positions = positions[None, :]
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def out_proj(p, o: torch.Tensor) -> torch.Tensor:
    """o: [..., H, hd] -> [..., d] through ``wo [H, hd, d]``.  On a mesh,
    heads that do not divide the model axis come in blocks of unequal size,
    which DTensor cannot merge with hd: they are gathered first."""
    H, hd, d = p["wo"].shape
    if isinstance(o, DTensor) and any(
            pl.is_shard(o.ndim - 2) and o.shape[-2] % o.device_mesh.size(i)
            for i, pl in enumerate(o.placements)):
        o = shard(o, "batch", *[None] * (o.ndim - 1))
    return rows_out(o.reshape(*o.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, d))


def attn_full(p, cfg: ArchConfig, x: torch.Tensor, *, causal: bool = True,
              window: int = 0, impl: str = "kernel", min_rows: int = 0,
              kv_follow: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill); x: [B, S, d] normalised input.
    Returns (out [B, S, d], roped k [B, S, KV, hd], v [B, S, KV, hd]).
    ``impl``: see :func:`repro_torch.models.attention.prefill_attention`;
    ``min_rows``, ``kv_follow`` (k and v then one per query head): see
    :func:`project_qkv`."""
    S = x.shape[1]
    q, k, v = project_qkv(p, cfg, x, torch.arange(S, device=x.device), min_rows, kv_follow)
    if current_context() is not None and cfg.num_heads % model_axis_size() == 0:
        q = shard(q, "batch", None, "heads", None)
    o = attn_lib.prefill_attention(q, k, v, causal=causal, window=window, impl=impl)
    return out_proj(p, o), k, v


def attn_full_tp(p, shards: Shards, cfg: ArchConfig, x: torch.Tensor, *,
                 impl: str = "kernel", min_rows: int = 0):
    """:func:`attn_full` (causal) under tensor parallelism: each shard
    projects its heads and runs the prefill attention on its device, and the
    outputs are concatenated on the head axis before the replicated ``wo``.
    Returns (out [B, S, d], per-shard roped k and v [B, S, KV/tp, hd])."""
    S = x.shape[1]
    outs, ks, vs = [], [], []
    for sp in shards:
        dev = sp["wq"].device
        q, k, v = project_qkv(sp, cfg, x.to(dev), torch.arange(S, device=dev), min_rows)
        outs.append(attn_lib.prefill_attention(q, k, v, causal=True, impl=impl))
        ks.append(k)
        vs.append(v)
    return out_proj(p, tp_allgather(outs, 2, x.device)), ks, vs


def attn_params(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    """``wq [d, H, hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H, hd, d]`` and,
    with ``qk_norm``, the q/k norm scales (uninitialised)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": param((d, H, hd), dtype, device),
            "wk": param((d, KV, hd), dtype, device),
            "wv": param((d, KV, hd), dtype, device),
            "wo": param((H, hd, d), dtype, device)}
    if cfg.qk_norm:
        attn["q_norm"] = param((hd,), torch.float32, device)
        attn["k_norm"] = param((hd,), torch.float32, device)
    return nn.ParameterDict(attn)


def attn_logical_axes(cfg: ArchConfig) -> dict:
    ax = {"wq": (None, "heads", None), "wk": (None, "kv_heads", None),
          "wv": (None, "kv_heads", None), "wo": ("heads", None, None)}
    if cfg.qk_norm:
        ax["q_norm"] = (None,)
        ax["k_norm"] = (None,)
    return ax


def init_attn(attn: nn.ParameterDict, cfg: ArchConfig, g: torch.Generator) -> None:
    """The reference's ``attn_params`` distributions."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    for n in ("q_norm", "k_norm"):
        if n in attn:
            attn[n].data.fill_(1.0)
    for n, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", H * hd)):
        w = attn[n]
        w.data.copy_(dense_init(g, w.shape, fan_in, w.dtype, w.device))


def layer_pattern(cfg: ArchConfig) -> Tuple[List[str], List[str], int]:
    """The reference's ``DenseLM._pattern``: (prefix kinds, the kinds of
    one repeated group, the number of groups)."""
    if cfg.moe is None:
        return [], ["dense"], cfg.num_layers
    moe = cfg.moe
    prefix = ["dense0"] * moe.first_dense_layers
    rem = cfg.num_layers - moe.first_dense_layers
    if moe.interleave == 1:
        return prefix, ["moe"], rem
    if rem % moe.interleave != 0:
        raise ValueError("num_layers incompatible with moe.interleave")
    return prefix, ["moe"] + ["dense"] * (moe.interleave - 1), rem // moe.interleave


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """[..., KV, hd] -> int8 codes and per-(position, head) float32 scales
    ``max|x| / 127 + 1e-8`` (round half to even, as ``jnp.round``)."""
    def q8(x):
        x = x.float()
        scale = x.abs().amax(dim=-1) / 127.0 + 1e-8
        return torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8), scale

    kq, ks = q8(k)
    vq, vs = q8(v)
    return kq, vq, ks, vs


def mlp_apply_aux(blk: "Block", x: torch.Tensor, shards: Optional[Shards] = None,
                  min_rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mlp_apply` on x [B, S, d] with the MoE's load-balance loss
    (a float32 zero for a SwiGLU layer), as the reference's ``_mlp_apply``."""
    if blk.kind == "moe":
        return moe_apply(blk.moe, x, blk.moe.cfg)
    return mlp_apply(blk, x, shards, min_rows), x.new_zeros((), dtype=torch.float32)


def mlp_apply(blk: "Block", x: torch.Tensor,
              shards: Optional[Shards] = None, min_rows: int = 0) -> torch.Tensor:
    """The layer's FFN: SwiGLU, or the MoE for a ``moe`` layer.  A 2-D
    ``x`` [B, d] (a decode pass) goes through the MoE as B rows of one
    token each, as the reference's decode does.  With a dense layer's
    ``shards`` each shard computes its d_ff columns of the SwiGLU hidden on
    its device, concatenated before the replicated ``w_down``.  A prefill
    passes ``min_rows`` for the SwiGLU's gate/up (``layers.rows_matmul``)."""
    if blk.kind != "moe":
        if shards is None:
            return swiglu_apply(blk.mlp, x, min_rows)
        h = tp_allgather([swiglu_hidden(sp, x.to(sp["w_gate"].device), min_rows)
                          for sp in shards], -1, x.device)
        return h @ blk.mlp["w_down"]
    if x.ndim == 2:
        return moe_apply(blk.moe, x[:, None, :], blk.moe.cfg)[0][:, 0]
    return moe_apply(blk.moe, x, blk.moe.cfg)[0]


class Block(nn.Module):
    """One decoder layer: RMSNorm → GQA attention → RMSNorm → FFN, where the
    FFN is a SwiGLU (kinds ``dense`` and ``dense0``, the latter at
    ``first_dense_d_ff``) or the MoE (kind ``moe``)."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype: torch.dtype, device):
        super().__init__()
        f32 = torch.float32
        self.kind = kind
        self.ln1 = param((cfg.d_model,), f32, device)
        self.ln2 = param((cfg.d_model,), f32, device)
        self.attn = attn_params(cfg, dtype, device)
        if kind == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe, dtype, device)
        else:
            width = cfg.moe.first_dense_d_ff if kind == "dense0" and cfg.moe else cfg.d_ff
            self.mlp = mlp_params(cfg.d_model, width, dtype, device)

    def init(self, cfg: ArchConfig, g: torch.Generator) -> None:
        for n in ("ln1", "ln2"):
            getattr(self, n).data.fill_(1.0)
        init_attn(self.attn, cfg, g)
        if self.kind == "moe":
            self.moe.init(g)
        else:
            init_mlp(self.mlp, g)

    def full(self, cfg: ArchConfig, x: torch.Tensor, impl: str = "kernel",
             shards: Optional[Shards] = None, kv_follow: bool = False):
        """Causal full-sequence layer; returns (x, roped k, v, the MoE's
        load-balance loss), with ``shards`` the per-shard lists of k and v
        (``kv_follow``: see :func:`project_qkv`)."""
        h = rms_norm(x, self.ln1, cfg.rms_eps)
        rows = PREFILL_MIN_ROWS
        if shards is None:
            o, k, v = attn_full(self.attn, cfg, h, impl=impl, min_rows=rows,
                                kv_follow=kv_follow)
        else:
            o, k, v = attn_full_tp(self.attn, shards, cfg, h, impl=impl, min_rows=rows)
        x = shard(x + o, "batch", "seq", None)
        m, aux = mlp_apply_aux(self, rms_norm(x, self.ln2, cfg.rms_eps), shards, rows)
        return shard(x + m, "batch", "seq", None), k, v, aux


class DenseLM(nn.Module):
    """Decoder-only LM of the dense, moe and vlm families.

    Weights are allocated uninitialised: call :meth:`init` (random, from a
    ``torch.Generator``) or load them (``load_state_dict``, or
    :func:`repro_torch.models.bridge.load_reference_params`)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: DenseLM serves the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        if cfg.kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_size), dtype, dev)
        prefix, group, n_groups = layer_pattern(cfg)
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, dev)
                                    for kind in prefix + group * n_groups)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)

    def init(self, generator: torch.Generator) -> "DenseLM":
        """Random weights with the reference's distributions: N(0, 1/fan_in)
        projections, N(0, 0.02²) embeddings, unit norms."""
        cfg = self.cfg
        self.embed.data.copy_(embed_init(generator, self.embed.shape, self.embed.dtype, self.device))
        self.final_norm.data.fill_(1.0)
        if not cfg.tie_embeddings:
            self.unembed.data.copy_(embed_init(generator, self.unembed.shape,
                                               self.unembed.dtype, self.device))
        for blk in self.layers:
            blk.init(cfg, generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_logical_axes(self) -> Dict[str, Tuple]:
        """{parameter name: logical axes}, the reference's axes (its
        stacked leaves' leading layer axis dropped)."""
        cfg = self.cfg
        ax = {"embed": ("vocab", None), "final_norm": (None,)}
        if not cfg.tie_embeddings:
            ax["unembed"] = (None, "vocab")
        for i, blk in enumerate(self.layers):
            layer = {"ln1": (None,), "ln2": (None,), "attn": attn_logical_axes(cfg)}
            if blk.kind == "moe":
                layer["moe"] = moe_logical_axes(cfg.moe)
            else:
                layer["mlp"] = swiglu_logical_axes()
            ax.update(flat_axes(f"layers.{i}.", layer))
        return ax

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.embed, tokens).to(self.act_dtype)

    def final_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, d] last hidden states -> float32 logits [B, V]."""
        return logits_last(rms_norm(x, self.final_norm, self.cfg.rms_eps),
                           self.unembed_matrix())

    def _embed_prompt(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's ``_embed_tokens``: a vlm's ``patch_embeds``
        [B, P, d] replace the first P positions, in the activation dtype,
        whenever the (padded) prompt holds at least P positions."""
        x = self.embed_tokens(tokens.to(self.device))
        P = self.cfg.modality.num_embeds if self.cfg.modality is not None else 0
        if P and patch_embeds is not None and tokens.shape[1] >= P:
            pe = torch.as_tensor(patch_embeds).to(self.device, self.act_dtype)
            x = torch.cat([pe, x[:, P:]], dim=1)
        return shard(x, "batch", "seq", None)

    # -- train ---------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]):
        """The reference's training loss: ``batch`` holds ``tokens``,
        ``targets`` [B, S] int, ``loss_mask`` [B, S] float and, for a vlm,
        ``patch_embeds``.  Every layer runs the plain attention
        (:func:`~repro_torch.models.attention.chunked_attention`: the kernels
        have no backward); the layers after the prefix go in groups of the
        reference's repeated pattern, each group checkpointed under
        ``remat_policy``.  Returns (xent + AUX_LOSS_WEIGHT * aux /
        num_layers, {"xent", "aux"}), aux the MoE layers' summed
        load-balance loss."""
        cfg, dev = self.cfg, self.device
        prefix, group, _ = layer_pattern(cfg)
        x = self._embed_prompt(batch["tokens"], batch.get("patch_embeds"))
        aux = torch.zeros((), dtype=torch.float32, device=dev)

        follow = kv_follow_queries(cfg)  # k and v feed the attention only

        def run(layers, x, aux):
            for blk in layers:
                x, _, _, a = blk.full(cfg, x, impl="plain", kv_follow=follow)
                aux = aux + a
            return x, aux

        P, r = len(prefix), len(group)
        x, aux = run(self.layers[:P], x, aux)
        for g0 in range(P, cfg.num_layers, r):
            x, aux = maybe_remat(lambda x, aux, g0=g0: run(self.layers[g0:g0 + r], x, aux),
                                 cfg.remat_policy)(x, aux)
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        xent, _ = softmax_xent(x, self.unembed_matrix(), batch["targets"].to(dev),
                               batch["loss_mask"].to(dev))
        loss = xent + AUX_LOSS_WEIGHT * aux / max(cfg.num_layers, 1)
        return loss, {"xent": xent, "aux": aux}

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """{name: (shape, dtype name, logical axes)} of a dry-run cell's
        inputs: the token inputs and, for a vlm's train and prefill cells,
        its ``patch_embeds`` [B, P, d]."""
        cfg = self.cfg
        specs = token_specs(shape)
        if (cfg.modality is not None and cfg.modality.num_embeds
                and shape.kind in ("train", "prefill")):
            specs["patch_embeds"] = ((shape.global_batch, cfg.modality.num_embeds, cfg.d_model),
                                     cfg.activation_dtype, ("batch", None, None))
        return specs

    # -- serve: cache --------------------------------------------------------
    def cache_shape(self, batch: int, capacity: int):
        """{name: (shape, dtype name, logical axes)} of the contiguous cache:
        ``k``/``v`` [L, B, capacity, KV, hd] in the activation dtype, or in
        int8 with float32 ``k_scale``/``v_scale`` [L, B, capacity, KV] when
        ``kv_cache_dtype == "int8"``, and ``lens`` [B]."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        lens = {"lens": ((batch,), "int32", ("batch",))}
        if cfg.kv_cache_dtype == "int8":
            sc = kv[:-1]
            return {"k": (kv, "int8", axes), "v": (kv, "int8", axes),
                    "k_scale": (sc, "float32", axes[:-1]),
                    "v_scale": (sc, "float32", axes[:-1]), **lens}
        return {"k": (kv, cfg.activation_dtype, axes),
                "v": (kv, cfg.activation_dtype, axes), **lens}

    def init_cache(self, batch: int, capacity: int) -> Cache:
        """Zeros of :meth:`cache_shape`; under a sharding context on a mesh,
        the K/V leaves are DTensors laid out by their logical axes (``lens``
        stays whole on every rank)."""
        shapes = self.cache_shape(batch, capacity)
        cache = zeros_cache(shapes, self.device)
        ctx = current_context()
        if ctx is not None and ctx.distributed:
            cache = {k: t if k == "lens" else ctx.distribute(t, shapes[k][2])
                     for k, t in cache.items()}
        return cache

    # -- serve: prefill ------------------------------------------------------
    @serving
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                true_lens: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                impl: str = "kernel",
                shards: Optional[List[Shards]] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] -> (next-token logits [B, V], cache).

        ``true_lens`` [B] marks each row's unpadded length when prompts are
        packed into one padded batch: logits are taken at ``true_lens - 1``.
        Padding must be a suffix (causal attention keeps valid positions
        exact); a moe layer's capacity follows the padded S.  A vlm's
        ``patch_embeds`` [B, P, d] replace the first P positions when
        S >= P.  The cache holds ``k``/``v`` [L, B, capacity, KV, hd] (int8
        codes plus ``k_scale``/``v_scale`` with ``kv_cache_dtype="int8"``)
        and ``lens`` [B].  Attention runs the flash prefill kernel once per
        layer (``impl="kernel"``) or its plain version (``impl="plain"``,
        for oracles).  With tensor-parallel ``shards`` (per layer) each
        shard's attention runs on its device and ``k``/``v`` are lists of the
        shards' [L, B, S, KV/tp, hd].
        """
        B, S = tokens.shape
        capacity = capacity or S
        x = self._embed_prompt(tokens, patch_embeds)
        follow = shards is None and kv_follow_queries(self.cfg)
        ks, vs = [], []
        for i, blk in enumerate(self.layers):
            x, k, v, _ = blk.full(self.cfg, x, impl, None if shards is None else shards[i],
                                  kv_follow=follow)
            if follow:  # the cache keeps every KV head
                k, v = kv_heads(k, self.cfg), kv_heads(v, self.cfg)
            ks.append(k)
            vs.append(v)
        lens = self._row_lens(B, S, true_lens)
        logits = self._logits_at(x, lens)
        if shards is not None:
            return logits, {"k": [torch.stack(k) for k in zip(*ks)],
                            "v": [torch.stack(v) for v in zip(*vs)], "lens": lens}
        k_all, v_all = torch.stack(ks), torch.stack(vs)
        if capacity > S:
            pad = (0, 0, 0, 0, 0, capacity - S)
            k_all = torch.nn.functional.pad(k_all, pad)
            v_all = torch.nn.functional.pad(v_all, pad)
        if self.cfg.kv_cache_dtype == "int8":
            kq, vq, k_scale, v_scale = quantize_kv(k_all, v_all)
            return logits, {"k": kq, "v": vq, "k_scale": k_scale, "v_scale": v_scale,
                            "lens": lens}
        return logits, {"k": k_all, "v": v_all, "lens": lens}

    def _row_lens(self, B: int, S: int, true_lens: Optional[torch.Tensor]) -> torch.Tensor:
        if true_lens is None:
            return torch.full((B,), S, dtype=torch.int32, device=self.device)
        return true_lens.to(self.device, torch.int32)

    def _logits_at(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """Next-token logits at each row's last valid position ``lens - 1``."""
        B, S = x.shape[:2]
        return self.final_logits(
            x[torch.arange(B, device=self.device), (lens.long() - 1).clamp(0, S - 1)])

    # -- serve: partial prefill over a cached prefix (prefix cache) ----------
    def _suffix_prefill(self, tokens: torch.Tensor, prefix_lens: torch.Tensor,
                        attend, true_lens: Optional[torch.Tensor],
                        shards: Optional[List[Shards]] = None):
        """The layer stack of a suffix prefill: positions offset by
        ``prefix_lens``, each layer's attention ``attend(i, q, k, v)``; with
        tensor-parallel ``shards``, ``attend(i, qs, ks, vs)`` over the
        shards' lists returns the shards' outputs.  Returns (logits [B, V],
        suffix k/v [L, B, S, KV, hd] on this model's device)."""
        cfg, dev = self.cfg, self.device
        B, S = tokens.shape
        prefix_lens = prefix_lens.to(dev)
        positions = prefix_lens.long()[:, None] + torch.arange(S, device=dev)[None, :]
        x = self.embed_tokens(tokens.to(dev))
        ks, vs = [], []
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            sh = None if shards is None else shards[i]
            if sh is None:
                q, k, v = project_qkv(blk.attn, cfg, h, positions, PREFILL_MIN_ROWS)
                o = attend(i, q, k, v)
            else:
                qs, kss, vss = map(list, zip(*(
                    project_qkv(sp, cfg, h.to(sp["wq"].device), positions.to(sp["wq"].device),
                                PREFILL_MIN_ROWS)
                    for sp in sh)))
                o = tp_allgather(attend(i, qs, kss, vss), 2, dev)
                k, v = tp_allgather(kss, 2, dev), tp_allgather(vss, 2, dev)
            x = x + out_proj(blk.attn, o.to(x.dtype))
            x = x + mlp_apply(blk, rms_norm(x, blk.ln2, cfg.rms_eps), sh, PREFILL_MIN_ROWS)
            ks.append(k)
            vs.append(v)
        return self._logits_at(x, self._row_lens(B, S, true_lens)), torch.stack(ks), torch.stack(vs)

    @serving
    def prefill_with_prefix(self, tokens: torch.Tensor, prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, prefix_lens: torch.Tensor, *,
                            true_lens: Optional[torch.Tensor] = None):
        """Prefill only the suffix ``tokens`` [B, S] of prompts whose first
        ``prefix_lens[b]`` tokens have cached K/V: ``prefix_k``/``prefix_v``
        [L, B, T, KV, hd] (roped at their own positions, padded to T).  Every
        layer attends over prefix + causal suffix
        (:func:`~repro_torch.models.attention.prefix_attention`).  Returns
        (next-token logits [B, V], suffix k/v [L, B, S, KV, hd])."""
        dt = self.act_dtype
        pk, pv = prefix_k.to(self.device, dt), prefix_v.to(self.device, dt)
        lens = prefix_lens.to(self.device)
        return self._suffix_prefill(
            tokens, prefix_lens,
            lambda i, q, k, v: attn_lib.prefix_attention(q, pk[i], pv[i], lens, k, v),
            true_lens)

    @serving
    def prefill_with_host_prefix(self, tokens: torch.Tensor, prefix_lens: torch.Tensor, *,
                                 prefix_cb: Callable,
                                 true_lens: Optional[torch.Tensor] = None,
                                 shards: Optional[List[Shards]] = None):
        """:meth:`prefill_with_prefix` for a prefix the host serves in place
        (zero-copy host serving): every layer hands its suffix queries
        [B, S, H, hd] to ``prefix_cb(layer, q) -> (acc, l, m)``, float32
        flash partials over the host-pool prefix pages (arrays or tensors),
        and merges them with the causal suffix attention on this model's
        device (:func:`~repro_torch.models.attention.suffix_attention_merge`).
        The callback takes the place of the reference's ordered
        ``io_callback``; the prefix itself never crosses PCIe.  With
        tensor-parallel ``shards``, ``prefix_cb(layer, qs)`` takes the
        shards' queries [B, S, H/tp, hd] and returns one partial per shard,
        each merged on its shard's device."""
        dev = self.device

        def attend(i, q, k, v):
            acc, l, m = (torch.as_tensor(t).to(dev) for t in prefix_cb(i, q))
            return attn_lib.suffix_attention_merge(q, k, v, acc, l, m)

        def attend_tp(i, qs, ks, vs):
            return [attn_lib.suffix_attention_merge(
                q, k, v, *(torch.as_tensor(t).to(q.device) for t in part))
                for q, k, v, part in zip(qs, ks, vs, prefix_cb(i, qs))]

        return self._suffix_prefill(tokens, prefix_lens, attend if shards is None else attend_tp,
                                    true_lens, shards)

    # -- serve: decode over a contiguous cache (the oracle) ------------------
    def decode(self, tokens: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B] -> (logits [B, V], cache).  Writes each row's new K/V
        at position ``lens`` in place (the reference returns a new cache;
        the port updates in place to save a copy of the whole cache) and
        attends over ``lens + 1`` tokens.  Over an int8 cache the new K/V
        are quantised, and each layer attends over its cache dequantised to
        the activation dtype (the reference's ``attn_decode_int8``).  On a
        mesh (a DTensor cache from :meth:`init_cache` under a context) with
        ``kv_shard_mode="blocks"`` each layer runs the split-K
        ``decode_attention_blocksharded`` over the model axis; it runs
        under ``no_grad`` there (DTensor views refuse inference mode)."""
        mode = torch.no_grad() if isinstance(cache["k"], DTensor) else torch.inference_mode()
        with mode:
            return self._decode(tokens, cache)

    def _decode(self, tokens: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        cfg = self.cfg
        cache = reduce_partials(cache)
        lens = cache["lens"]
        B = tokens.shape[0]
        rows = torch.arange(B, device=self.device)
        pos = lens.long().clamp(0, cache["k"].shape[2] - 1)
        int8 = cfg.kv_cache_dtype == "int8"
        ctx = current_context()
        blocks = (cfg.kv_shard_mode == "blocks" and not int8 and ctx is not None
                  and ctx.distributed and "model" in ctx.mesh.mesh_dim_names)
        follow = kv_follow_queries(cfg)
        x = shard(self.embed_tokens(tokens.to(self.device)), "batch", None)
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.ln1, cfg.rms_eps)
            q, k, v = project_qkv(blk.attn, cfg, h[:, None, :], lens[:, None], kv_follow=follow)
            if follow:  # the cache keeps every KV head
                k, v = kv_heads(k, cfg), kv_heads(v, cfg)
            if int8:
                kq, vq, k_scale, v_scale = quantize_kv(k[:, 0], v[:, 0])
                for name, new in (("k", kq), ("v", vq), ("k_scale", k_scale),
                                  ("v_scale", v_scale)):
                    cache[name][i, rows, pos] = new
                dt = self.act_dtype
                kc = cache["k"][i].to(dt) * cache["k_scale"][i][..., None].to(dt)
                vc = cache["v"][i].to(dt) * cache["v_scale"][i][..., None].to(dt)
            elif blocks:
                # split-K over the model axis; writes this layer's K/V blocks
                o, _, _ = attn_lib.decode_attention_blocksharded(
                    q[:, 0], cache["k"][i], cache["v"][i], k[:, 0], v[:, 0], lens)
            else:
                attn_lib.write_kv(cache["k"][i], cache["v"][i], k[:, 0], v[:, 0], lens)
                kc, vc = cache["k"][i], cache["v"][i]
            if not blocks:
                o = attn_lib.decode_attention(q[:, 0], kc, vc, lens + 1)
            # the residual stream whole over the model axis (as in prefill):
            # a partial sum left to DTensor would make every model rank
            # compute the next layer's full projections
            x = shard(x + out_proj(blk.attn, o), "batch", None)
            x = shard(x + mlp_apply(blk, rms_norm(x, blk.ln2, cfg.rms_eps)), "batch", None)
        return self.final_logits(x), {**cache, "lens": lens + 1}
