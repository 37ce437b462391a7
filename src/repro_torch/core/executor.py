"""Execution backends of the NEO engine (serial path).

:class:`PagedExecutor` (dense family) runs decode over the paged dual-pool
KV cache and cold prefill.  Per decode step and layer:

* the projections (norm, QKV, qk_norm, RoPE) run on the device for all rows;
* device rows append their new K/V to the device pool in place;
* host rows take the explicit handoff that replaces the reference's ordered
  ``io_callback``: their q/k/v are copied to the host,
  :meth:`HostAttention.run_layer` appends the K/V to the host pool and
  attends there, and the result is copied back — the paper's
  TrQKV → CPU-attn → TrO;
* one call of the paged decode kernel covers all rows, with ``lens = 0``
  for host rows (the kernel returns zeros there), and host rows take the
  host output — so the attention kernel launches exactly ``num_layers``
  times per :meth:`decode` call, each followed by a launch of its merge
  kernel when the rows' pages are split into ranges;
* the output projection and FFN run on the device for all rows.

Per-row compute is independent of the other rows, so a row's logits do not
depend on which rows share its batch (up to the matmul's choice of
algorithm for a different row count on the card; ROADMAP ground rule 3).
The pipelined host lanes, row/page buckets for jit and tensor parallelism of
the reference executor are not ported here (ROADMAP P7, P13).

:class:`ContiguousExecutor` (ssm and hybrid families, device-only) keeps one
slot of a contiguous cache per active request and runs the model's own
prefill (one request at a time) and decode (all slots at once).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.core.host_attention import HostAttention
from repro_torch.core.kv_cache import DualPool
from repro_torch.core.request import Request
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.models.layers import rms_norm, swiglu_apply
from repro_torch.models.transformer import DenseLM, out_proj, project_qkv


class PagedExecutor:
    """Paged decode + cold prefill for the dense family."""

    def __init__(self, model: DenseLM, pool: DualPool, host_attn: HostAttention):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.pool = pool
        self.host = host_attn
        self.page = pool.page_size
        self.device = model.device

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _layer_pre(self, blk, x: torch.Tensor, positions: torch.Tensor):
        h = rms_norm(x, blk.ln1, self.cfg.rms_eps)
        q, k, v = project_qkv(blk.attn, self.cfg, h[:, None, :], positions[:, None])
        return q[:, 0], k[:, 0], v[:, 0]  # [D,H,hd], [D,KV,hd]

    def _layer_post(self, blk, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        x = x + out_proj(blk.attn, o)
        return x + swiglu_apply(blk.mlp, rms_norm(x, blk.ln2, self.cfg.rms_eps))

    @torch.inference_mode()
    def decode(self, rows: List[Request], host_flags: List[bool]) -> np.ndarray:
        """One decode iteration over ``rows``; returns float32 logits
        [n_rows, V].  Page allocation for the new token must already be done
        (engine)."""
        n, page, dev = len(rows), self.page, self.device
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int64)
        pids = np.zeros((n,), np.int64)
        offs = np.zeros((n,), np.int64)
        for i, r in enumerate(rows):
            pos = r.kv_len  # next position
            tokens[i] = r.all_tokens[-1]
            positions[i] = pos
            pids[i] = r.pages[pos // page]
            offs[i] = pos % page
        is_host = np.asarray(host_flags, bool)
        dev_idx = np.flatnonzero(~is_host)
        host_idx = np.flatnonzero(is_host)

        # device rows: block tables over their pages, attend over pos + 1
        mp = max([len(rows[i].pages) for i in dev_idx] + [1])
        tables = np.zeros((n, mp), np.int32)
        lens = np.zeros((n,), np.int32)  # 0 for host rows: the kernel gives zeros
        for i in dev_idx:
            tables[i, : len(rows[i].pages)] = rows[i].pages
            lens[i] = positions[i] + 1
        tables_t = torch.from_numpy(tables).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        dev_idx_t = torch.from_numpy(dev_idx).to(dev)
        dev_pid_t = torch.from_numpy(pids[dev_idx]).to(dev)
        dev_off_t = torch.from_numpy(offs[dev_idx]).to(dev)
        host_idx_t = torch.from_numpy(host_idx).to(dev)

        # host rows: tables in the HOST pool, lens before the append
        max_hp = max([len(rows[i].pages) for i in host_idx] + [1])
        h_tables = np.zeros((len(host_idx), max_hp), np.int32)
        for j, i in enumerate(host_idx):
            h_tables[j, : len(rows[i].pages)] = rows[i].pages
        h_rows = np.arange(len(host_idx))
        h_lens = positions[host_idx].astype(np.int32)
        h_pids = pids[host_idx].astype(np.int32)
        h_offs = offs[host_idx].astype(np.int32)

        model, pk, pv = self.model, self.pool.device.k, self.pool.device.v
        x = model.embed_tokens(torch.from_numpy(tokens).to(dev))
        pos_t = torch.from_numpy(positions).to(dev)
        for li, blk in enumerate(model.layers):
            q, k, v = self._layer_pre(blk, x, pos_t)
            if len(dev_idx):
                pk[li, dev_pid_t, dev_off_t] = k[dev_idx_t].to(pk.dtype)
                pv[li, dev_pid_t, dev_off_t] = v[dev_idx_t].to(pv.dtype)
            o = paged_ops.paged_decode_attention(q.contiguous(), pk[li], pv[li],
                                                 tables_t, lens_t)
            if len(host_idx):
                # TrQKV (one copy) -> CPU attention -> TrO
                R = len(host_idx)
                qkv = torch.cat([t[host_idx_t].reshape(R, -1) for t in (q, k, v)], dim=1)
                qkv = qkv.float().cpu().numpy()
                nq, nk = q[0].numel(), k[0].numel()
                qh = qkv[:, :nq].reshape(R, *q.shape[1:])
                kh = qkv[:, nq:nq + nk].reshape(R, *k.shape[1:])
                vh = qkv[:, nq + nk:].reshape(R, *v.shape[1:])
                oh = self.host.run_layer(li, qh, kh, vh, host_rows=h_rows,
                                         tables=h_tables, lens=h_lens,
                                         page_ids=h_pids, offsets=h_offs)
                o[host_idx_t] = torch.from_numpy(oh).to(dev).to(o.dtype)
            x = self._layer_post(blk, x, o)
        return model.final_logits(x).cpu().numpy()

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, reqs: List[Request], to_host: List[bool]) -> np.ndarray:
        """Cold prefill of ``reqs`` as one padded batch, scattering each
        request's K/V into the pages already allocated on ``req.pages`` in
        its pool.  Returns first-token float32 logits [n, V]."""
        n, page = len(reqs), self.page
        S = max(r.prefill_len for r in reqs)
        tokens = np.zeros((n, S), np.int64)
        lens = np.zeros((n,), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : r.prefill_len] = r.prefill_tokens
            lens[i] = r.prefill_len
        logits, cache = self.model.prefill(torch.from_numpy(tokens),
                                           true_lens=torch.from_numpy(lens))
        k_all, v_all = cache["k"], cache["v"]  # [L, n, S, KV, hd]
        for i, (r, host) in enumerate(zip(reqs, to_host)):
            npages = len(r.pages)
            kr, vr = k_all[:, i], v_all[:, i]
            s_pad = npages * page
            if s_pad > S:
                pad = (0, 0, 0, 0, 0, s_pad - S)
                kr = torch.nn.functional.pad(kr, pad)
                vr = torch.nn.functional.pad(vr, pad)
            else:
                kr, vr = kr[:, :s_pad], vr[:, :s_pad]
            kr = kr.reshape(kr.shape[0], npages, page, *kr.shape[2:])
            vr = vr.reshape(vr.shape[0], npages, page, *vr.shape[2:])
            if host:
                self.pool.host.put_pages(r.pages, kr, vr)
                # layer-wise PCIe copy of the freshly computed KV
                self.pool.add_swap_bytes(2 * kr.numel() * self.pool.host.k.element_size())
            else:
                self.pool.device.put_pages(r.pages, kr, vr)
        return logits.cpu().numpy()


# ---------------------------------------------------------------------------
# Contiguous slot executor (ssm / hybrid; device-only)
# ---------------------------------------------------------------------------


class ContiguousExecutor:
    """Slot-based contiguous-cache executor driven by the model's own
    prefill/decode.  One slot per active request; decode computes every slot
    and advances the decoding ones."""

    def __init__(self, model, *, slots: int, capacity: int):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.slots = slots
        self.capacity = capacity
        self.device = model.device
        shapes = model.cache_shape(slots, capacity)
        self._batch_axes: Dict[str, int] = {name: axes.index("batch")
                                            for name, (_, _, axes) in shapes.items()}
        self.cache = model.init_cache(slots, capacity)
        self.free_slots = list(range(slots))

    # -- slot management ------------------------------------------------------
    def alloc_slot(self) -> int:
        return self.free_slots.pop(0)

    def free_slot(self, s: int) -> None:
        self.free_slots.insert(0, s)

    def _insert(self, one: Dict[str, torch.Tensor], slot: int) -> None:
        """Copy a one-request cache into ``slot`` of every leaf, zero-padding
        variable-size dims to the slot's shape."""
        for name, leaf in self.cache.items():
            ax = self._batch_axes[name]
            src = one[name]
            if src.shape[ax] == 1:
                src = src.select(ax, 0)
            dst = leaf.select(ax, slot)
            if src.shape != dst.shape:
                pad = []
                for have, want in zip(reversed(src.shape), reversed(dst.shape)):
                    pad += [0, want - have]
                src = torch.nn.functional.pad(src, pad)
            dst.copy_(src)

    # -- serve ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, req: Request, slot: int) -> np.ndarray:
        """Prefill ``req`` alone and insert its cache into ``slot``; returns
        its first-token float32 logits [V]."""
        tokens = torch.tensor([req.prefill_tokens], dtype=torch.long, device=self.device)
        logits, one = self.model.prefill(tokens, capacity=self.capacity)
        self._insert(one, slot)
        return logits[0].cpu().numpy()

    @torch.inference_mode()
    def decode(self, tokens_by_slot: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode step over every slot; returns float32 logits [slots, V].
        Only the ``active`` slots' caches advance: a slot prefilled in this
        iteration, or a free one, keeps its cache.  (The reference advances
        every slot, so a request prefilled in an iteration that also decodes
        other rows takes one step on token 0 before its first real decode;
        ROADMAP queue 3.)"""
        tokens = torch.from_numpy(np.asarray(tokens_by_slot, np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        logits, self.cache = self.model.decode(tokens, self.cache, active=mask)
        return logits.cpu().numpy()
