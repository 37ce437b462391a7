"""Execution backends of the NEO engine.

:class:`PagedExecutor` (dense, moe and vlm families) runs decode over the paged dual-pool
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

:meth:`decode` is the serial path (``pipeline=False``) and, restricted to
batch-0's rows, the pipelined engine's device lane (:meth:`decode_batch0`).
The pipelined engine's **host lanes** (:meth:`decode_host_lane`,
:meth:`submit_host_lane`) run the whole layer stack for host-only rows —
projections and FFN on the card, attention in :class:`HostAttention` —
without ever touching the device pool, so they run concurrently with the
device lane and with each other: each on a thread of a pool of
``host_lanes`` workers and on a CUDA stream of its own.  (On the legacy
default stream a lane's per-layer copy of q/k/v to the host would wait for
batch-0's queued kernels, and the overlap would silently vanish.)  Cold
prefill runs the flash prefill kernel once per layer on the batch padded to
the reference's length bucket (``_bucket(S, 16)``: a moe layer's capacity
follows the padded length, and a vlm's patches apply when it reaches their
count), with the model inputs the engine's ``extras_fn`` stacks for it;
prefix-cache hits prefill only their suffix, over the cached prefix gathered
from the device pool or, for host rows, over flash partials the host
computes on its prefix pages in place (plain attention, as the reference's
jnp: no kernel).

Per-row compute is independent of the other rows, so a row's logits do not
depend on which rows share its batch. As in the reference, every decode pass
pads its rows to the bucket :func:`_bucket` (powers of two, at least 8): the
GEMMs of the projections, FFN and logits then run at a bucket-sized row
count, so the serial pass, batch-0 and each host lane hand cuBLAS the same M
whenever their row counts share a bucket, and cuBLAS's choice of algorithm
(and summation order), which depends on M, cannot move a row's bf16 logits
(ROADMAP ground rule 3).  On the H100 the bucket alone is not enough: some
GEMMs change their algorithm between buckets (qwen3-0.6b's ``w_down`` at
128 rows, deepseek-moe-16b's FFNs already at 16), so the row-wise work runs
in slices of :data:`ROW_SLICE` rows, on the card exactly that many (the
last padded with zero rows), and a row's logits are the same in every
bucket.  A moe layer routes
each decode row as a batch row of one token (capacity 1; a row's top-k
experts are distinct, so nothing drops and rows stay independent), its
expert products batched matmuls over the bucket's rows.  Padded rows carry
token 0 at position 0 with ``lens = 0``; they never write to a pool, never
reach :class:`HostAttention`, and are dropped at the logits. The reference's
page buckets for jit are not ported.

Tensor parallelism (gather-TP, ``shard_devices`` of two or more): the
decode pass (serial, batch-0 and speculative verify passes) runs, per layer
and shard, the shard's QKV columns, the K/V write into the shard's pool and
the paged decode kernel over it (H/tp query heads, KV/tp KV heads); the
cpu0 host rows of every shard go to that shard's :class:`HostAttention`
over its KV-head view of the host pool, the shards' host calls running
concurrently on ``tp`` worker threads, each traced on its own
``hostattn-b0-s{shard}`` track; then the head concat, the replicated
``wo``, the shards' ``w_gate``/``w_up`` columns, the d_ff concat and the
replicated ``w_down`` and logits run once on the primary device.  Cold
prefill runs the flash prefill kernel per shard over its heads and writes
each shard's pool.  Host lanes and the gathered prefix prefill run the
unsharded weights (the latter reads and writes across the shards), and a
host-prefix prefill takes each shard's prefix partials from its
:class:`HostAttention` (``hostattn-prefix-s{shard}``), as the reference's
do.

:class:`ContiguousExecutor` (ssm, hybrid and audio families, device-only)
keeps one slot of a contiguous cache per active request and runs the
model's own prefill (one request at a time, with its extras: an
encoder-decoder's frames) and decode (all slots at once).
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.core.host_attention import HostAttention
from repro_torch.core.kv_cache import DualPool
from repro_torch.core.request import Request
from repro_torch.core.transfer import WAIT_TIMEOUT_S
from repro_torch.device import new_stream, on_stream
from repro_torch.distributed.sharding import tp_allgather
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.models.bridge import shard_state_dict
from repro_torch.models.layers import rms_norm, swiglu_hidden
from repro_torch.models.transformer import DenseLM, mlp_apply, out_proj, project_qkv


def _bucket(n: int, minimum: int = 8) -> int:
    """The reference's bucket: the smallest ``minimum * 2**i`` that holds
    ``n`` (decode rows: at least 8; prefill lengths: at least 16)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# The row count of every GEMM of a decode pass on the card.  cuBLAS picks
# its algorithm (and with it the summation order) by the row count M, and
# on the H100 a bf16 row's output moves with it: at qwen3-0.6b's widths
# ``w_down`` (K = 3072) drops its split-K between M = 64 and 128; at
# deepseek-moe-16b's, ``dense0``'s FFN (``w_down`` K = 10,944) moves a row
# between M = 8 and 16, and the experts' batched products between 32 and 64
# (PERF.md, tests/test_torch_moe_card.py).  So a pass's row-wise work
# (projections, FFN, logits) runs in slices of ROW_SLICE rows, and on the
# card the last one is padded with zero rows to exactly ROW_SLICE: every
# row of every pass (serial, batch-0, host lanes, verify passes) meets one
# GEMM shape, and a row's output is the same in every bucket.  The GEMMs
# stay bound by their weight reads at this M.  The CPU runs a short slice
# as it is: there the padding would multiply the smoke models' decode
# cost, and no CPU test's result depends on the row count.
ROW_SLICE = 64


def _in_row_slices(fn, *tensors):
    """``fn`` over ``tensors`` (rows first), in slices of ``ROW_SLICE``
    rows, the last one padded with zero rows to exactly ``ROW_SLICE`` on
    the card; the results concatenated along the rows and cut back to the
    rows given."""
    D = tensors[0].shape[0]
    pad = -D % ROW_SLICE if tensors[0].is_cuda else 0
    if pad:
        tensors = [torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) for t in tensors]
    parts = [fn(*(t[i:i + ROW_SLICE] for t in tensors)) for i in range(0, D + pad, ROW_SLICE)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p)[:D] if len(p) > 1 else p[0][:D] for p in zip(*parts))
    return torch.cat(parts)[:D] if len(parts) > 1 else parts[0][:D]


def _shard_rows(fn, tp: int, *tensors):
    """``fn`` over one decode slice's ``tensors`` (rows first) for a
    gather-TP shard's column-sharded GEMMs.  On the card the rows are padded
    with zero rows to ``tp`` times their count and the results cut back: the
    GEMM then computes tp x ROW_SLICE rows over 1/tp of the columns, as many
    output elements as the unsharded GEMM at ROW_SLICE rows, and cuBLAS
    splits K as it does there, so a column's bits are the unsharded
    GEMM's.  At ROW_SLICE rows alone it splits K further for the narrower
    N: qwen3-14b's ``wk``/``wv`` (K = 5120, N = 1024 -> 512) moved columns
    on the H100 (PERF.md; tests/test_torch_tp_card.py)."""
    n = tensors[0].shape[0]
    if tp == 1 or not tensors[0].is_cuda:
        return fn(*tensors)
    out = fn(*(torch.cat([t, t.new_zeros(((tp - 1) * n, *t.shape[1:]))]) for t in tensors))
    return tuple(o[:n] for o in out) if isinstance(out, tuple) else out[:n]


class PagedExecutor:
    """Paged decode + cold prefill for the dense, moe and vlm families."""

    def __init__(self, model: DenseLM, pool: DualPool, host_attn: HostAttention,
                 *, host_lanes: int = 2):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.pool = pool
        self.host = host_attn
        self.page = pool.page_size
        self.device = model.device
        # gather-TP: the shards follow the device pool's; the model keeps
        # the unsharded weights for host lanes and the gathered prefix path
        self.shard_devices = list(pool.device.devices)
        self.tp = len(self.shard_devices)
        self.host_shards: List[HostAttention] = []
        self.tp_layers: Optional[List[List[Dict[str, torch.Tensor]]]] = None
        self._shard_pool: Optional[ThreadPoolExecutor] = None
        if self.tp > 1:  # the engine has refused what gather-TP does not serve
            self.tp_layers = self._shard_layers()
            # one HostAttention per shard over a writable KV-head view of
            # the ONE host pool: page ids stay global
            for s in range(self.tp):
                k_s, v_s = pool.host.kv_head_slice(s, self.tp)
                self.host_shards.append(HostAttention(self.cfg, k_s, v_s,
                                                      threads=host_attn.threads))
            self._shard_pool = ThreadPoolExecutor(max_workers=self.tp,
                                                  thread_name_prefix="neo-hostshard")
        # Host lanes: ``host_lanes`` dispatch threads; lane ids are small
        # ints the engine assigns per step (the inline lane included), each
        # with a CUDA stream of its own.
        self.host_lanes = max(1, host_lanes)
        self._lane_pool = ThreadPoolExecutor(max_workers=self.host_lanes,
                                             thread_name_prefix="neo-hostlane")
        # the host leg of a prefill with both host and device prefix hits:
        # a thread of its own, so it never queues behind a busy host lane
        self._prefix_pool = ThreadPoolExecutor(max_workers=1,
                                               thread_name_prefix="neo-hostprefix")
        self._lane_streams: Dict[int, Optional[torch.cuda.Stream]] = {}
        self._streams_lock = threading.Lock()
        # tracing (repro_torch.obs): set by the engine; host attention and
        # the lane threads emit spans
        self.tracer = None

    def _shard_layers(self) -> List[List[Dict[str, torch.Tensor]]]:
        """Per layer, per shard: the shard's column slices of ``wq``/``wk``/
        ``wv`` and ``w_gate``/``w_up`` (and the replicated qk-norm scales)
        on its device."""
        cut = shard_state_dict(self.model.state_dict(), self.tp)
        out = []
        for i, blk in enumerate(self.model.layers):
            per = []
            for s, dev in enumerate(self.shard_devices):
                sp = {n: cut[s][f"layers.{i}.attn.{n}"].to(dev) for n in ("wq", "wk", "wv")}
                sp.update({n: cut[s][f"layers.{i}.mlp.{n}"].to(dev) for n in ("w_gate", "w_up")})
                for n in ("q_norm", "k_norm"):
                    if n in blk.attn:
                        sp[n] = blk.attn[n].detach().to(dev)
                per.append(sp)
            out.append(per)
        return out

    def _lane_stream(self, lane: int):
        with self._streams_lock:
            if lane not in self._lane_streams:
                self._lane_streams[lane] = new_stream(self.device)
            return self._lane_streams[lane]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _layer_pre(self, blk, x: torch.Tensor, positions: torch.Tensor):
        h = rms_norm(x, blk.ln1, self.cfg.rms_eps)
        q, k, v = project_qkv(blk.attn, self.cfg, h[:, None, :], positions[:, None])
        return q[:, 0], k[:, 0], v[:, 0]  # [D,H,hd], [D,KV,hd]

    def _layer_post(self, blk, x: torch.Tensor, o: torch.Tensor, shards=None) -> torch.Tensor:
        """Output projection and the layer's FFN (a moe layer routes each
        row as a batch row of one token: capacity 1, and its top-k experts
        are distinct, so no slot drops and rows stay independent); with
        gather-TP ``shards``, each shard's SwiGLU hidden columns
        (:func:`_shard_rows`), concatenated before the replicated
        ``w_down``."""
        x = x + out_proj(blk.attn, o)
        h = rms_norm(x, blk.ln2, self.cfg.rms_eps)
        if shards is None:
            return x + mlp_apply(blk, h)
        hid = tp_allgather([_shard_rows(functools.partial(swiglu_hidden, sp), self.tp,
                                        h.to(sp["w_gate"].device)) for sp in shards],
                           -1, x.device)
        return x + hid @ blk.mlp["w_down"]

    @torch.inference_mode()
    def decode(self, rows: List[Request], host_flags: List[bool]) -> np.ndarray:
        """One decode iteration over ``rows``; returns float32 logits
        [n_rows, V].  Page allocation for the new token must already be done
        (engine)."""
        n, page, dev = len(rows), self.page, self.device
        D = _bucket(n)  # rows n..D-1 are padding: token 0, position 0, lens 0
        tokens = np.zeros((D,), np.int64)
        positions = np.zeros((D,), np.int64)
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

        # device rows: block tables over their pages, attend over pos + 1.
        # The speculative verify pass (NeoEngine._run_spec_chain) hands in
        # pseudo-rows of one request that share its page list at successive
        # positions: every device row's K/V is written below before K1 runs
        # (and HostAttention.run_layer appends every host row before any
        # attends), so pseudo-row j reads the K/V of pseudo-rows < j of this
        # very call, and nothing past its own position (lens = pos + 1).  The
        # table width mp is not bucketed, unlike the reference's (it pads
        # its jit shapes): K1 reads only a row's first ceil(lens / page)
        # entries and splits them into ranges by the row's own length
        # (paged_decode.ops.split_pages), so the width moves no result.
        mp = max([len(rows[i].pages) for i in dev_idx] + [1])
        tables = np.zeros((D, mp), np.int32)
        lens = np.zeros((D,), np.int32)  # 0 for host and pad rows: the kernel gives zeros
        for i in dev_idx:
            tables[i, : len(rows[i].pages)] = rows[i].pages
            lens[i] = positions[i] + 1
        # the kernel's and the pool writes' inputs, per shard on its device
        by_dev: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        meta = []
        for d in self.shard_devices:
            if d not in by_dev:
                by_dev[d] = tuple(torch.from_numpy(a).to(d) for a in (
                    tables, lens, dev_idx, pids[dev_idx], offs[dev_idx], host_idx))
            meta.append(by_dev[d])

        # host rows: tables in the HOST pool, lens before the append
        h_meta = self._host_meta([rows[i] for i in host_idx], positions[host_idx], page)

        model = self.model
        x = model.embed_tokens(torch.from_numpy(tokens).to(dev))
        pos_t = torch.from_numpy(positions).to(dev)
        if self.tp > 1:
            return self._decode_tp(n, x, pos_t, meta, h_meta)
        tables_t, lens_t, dev_idx_t, dev_pid_t, dev_off_t, host_idx_t = meta[0]
        pk, pv = self.pool.device.k, self.pool.device.v
        for li, blk in enumerate(model.layers):
            q, k, v = _in_row_slices(functools.partial(self._layer_pre, blk), x, pos_t)
            if len(dev_idx):
                pk[li, dev_pid_t, dev_off_t] = k[dev_idx_t].to(pk.dtype)
                pv[li, dev_pid_t, dev_off_t] = v[dev_idx_t].to(pv.dtype)
            o = paged_ops.paged_decode_attention(q.contiguous(), pk[li], pv[li],
                                                 tables_t, lens_t)
            if len(host_idx):
                o[host_idx_t] = self._host_attention(
                    li, q[host_idx_t], k[host_idx_t], v[host_idx_t], h_meta, o.dtype,
                    "hostattn-b0")
            x = _in_row_slices(functools.partial(self._layer_post, blk), x, o)
        return _in_row_slices(model.final_logits, x)[:n].cpu().numpy()

    def _layer_pre_tp(self, blk, shards, x: torch.Tensor, positions: torch.Tensor):
        """:meth:`_layer_pre` per shard: the shard's q, k and v columns
        (H/tp and KV/tp heads) on its device, flattened over the shards."""
        def proj(sp, h, pos):
            q, k, v = project_qkv(sp, self.cfg, h[:, None, :], pos[:, None])
            return q[:, 0], k[:, 0], v[:, 0]

        h = rms_norm(x, blk.ln1, self.cfg.rms_eps)
        out = []
        for sp in shards:
            d = sp["wq"].device
            out += _shard_rows(functools.partial(proj, sp), self.tp, h.to(d), positions.to(d))
        return tuple(out)

    def _decode_tp(self, n: int, x: torch.Tensor, pos_t: torch.Tensor, meta, h_meta
                   ) -> np.ndarray:
        """The layer stack of :meth:`decode` under gather-TP: per shard the
        QKV columns, the pool write and K1 over the shard's pool, its host
        rows through the shard's :class:`HostAttention`; the head concat
        before the replicated ``wo`` and the sharded FFN
        (:meth:`_layer_post`) on the primary device."""
        model, pool = self.model, self.pool.device
        for li, blk in enumerate(model.layers):
            shards = self.tp_layers[li]
            qkv = _in_row_slices(functools.partial(self._layer_pre_tp, blk, shards), x, pos_t)
            outs = []
            for s in range(self.tp):
                q, k, v = qkv[3 * s: 3 * s + 3]
                pk, pv = pool.shard_k[s], pool.shard_v[s]
                tables_t, lens_t, dev_idx_t, dev_pid_t, dev_off_t, _ = meta[s]
                if len(dev_idx_t):
                    pk[li, dev_pid_t, dev_off_t] = k[dev_idx_t].to(pk.dtype)
                    pv[li, dev_pid_t, dev_off_t] = v[dev_idx_t].to(pv.dtype)
                outs.append(paged_ops.paged_decode_attention(q.contiguous(), pk[li], pv[li],
                                                             tables_t, lens_t))
            if len(h_meta[1]):
                self._host_attention_tp(li, qkv, outs, meta, h_meta)
            o = tp_allgather(outs, 1, self.device)
            x = _in_row_slices(functools.partial(self._layer_post, blk, shards=shards), x, o)
        return _in_row_slices(model.final_logits, x)[:n].cpu().numpy()

    def _host_attention_tp(self, li: int, qkv, outs: List[torch.Tensor], meta, h_meta) -> None:
        """Batch-0's host rows under gather-TP: per shard TrQKV of its heads
        (on this thread), the shards' :meth:`HostAttention.run_layer` calls
        concurrently on the shard threads, then TrO into each shard's
        attention output ``outs[s]``."""
        tables, lens, pids, offs = h_meta
        R = len(lens)
        futs = []
        for s in range(self.tp):
            host_idx_t = meta[s][5]
            q, k, v = (t[host_idx_t] for t in qkv[3 * s: 3 * s + 3])
            arr = torch.cat([t.reshape(R, -1) for t in (q, k, v)], dim=1).float().cpu().numpy()
            nq, nk = q[0].numel(), k[0].numel()
            qh = arr[:, :nq].reshape(R, *q.shape[1:])
            kh = arr[:, nq:nq + nk].reshape(R, *k.shape[1:])
            vh = arr[:, nq + nk:].reshape(R, *v.shape[1:])
            futs.append(self._shard_pool.submit(self._host_shard_layer, s, li, qh, kh, vh,
                                                h_meta))
        for s, fut in enumerate(futs):
            oh = fut.result(timeout=WAIT_TIMEOUT_S)
            outs[s][meta[s][5]] = torch.from_numpy(oh).to(outs[s].device).to(outs[s].dtype)

    def _host_shard_layer(self, s: int, li: int, qh, kh, vh, h_meta) -> np.ndarray:
        """Shard ``s``'s host attention for one layer (a shard thread),
        traced as span ``L{li}`` on ``hostattn-b0-s{s}``."""
        tables, lens, pids, offs = h_meta
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        oh = self.host_shards[s].run_layer(li, qh, kh, vh, host_rows=np.arange(len(lens)),
                                           tables=tables, lens=lens, page_ids=pids,
                                           offsets=offs)
        if tr is not None:
            tr.emit(f"hostattn-b0-s{s}", f"L{li}", t0, time.perf_counter(),
                    {"rows": len(lens), "shard": s})
        return oh

    def _host_attention(self, li: int, q, k, v, meta, dtype, track: str) -> torch.Tensor:
        """TrQKV (one copy) -> CPU attention over the host pool -> TrO for
        the host rows ``q``/``k``/``v`` [R, ...]; ``meta`` = (tables, lens,
        page ids, offsets) in the host pool.  Returns [R, H, hd] in
        ``dtype`` on the device.  Traced as span ``L{li}`` on ``track``."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        R = q.shape[0]
        tables, lens, pids, offs = meta
        qkv = torch.cat([t.reshape(R, -1) for t in (q, k, v)], dim=1)
        qkv = qkv.float().cpu().numpy()
        nq, nk = q[0].numel(), k[0].numel()
        qh = qkv[:, :nq].reshape(R, *q.shape[1:])
        kh = qkv[:, nq:nq + nk].reshape(R, *k.shape[1:])
        vh = qkv[:, nq + nk:].reshape(R, *v.shape[1:])
        oh = self.host.run_layer(li, qh, kh, vh, host_rows=np.arange(R), tables=tables,
                                 lens=lens, page_ids=pids, offsets=offs)
        o = torch.from_numpy(oh).to(self.device).to(dtype)
        if tr is not None:
            tr.emit(track, f"L{li}", t0, time.perf_counter(), {"rows": R})
        return o

    # batch-0 is the decode pass over device + cpu0 rows: exactly the serial
    # entry restricted to its sub-batch
    decode_batch0 = decode

    # ------------------------------------------------------------------
    # host lanes (host rows only; run off the engine thread)
    # ------------------------------------------------------------------
    @staticmethod
    def _host_meta(rows: List[Request], positions: np.ndarray, page: int):
        """Host-pool tables, lens before the append, page ids and offsets of
        the new token for ``rows``."""
        max_hp = max([len(r.pages) for r in rows] + [1])
        tables = np.zeros((len(rows), max_hp), np.int32)
        for j, r in enumerate(rows):
            tables[j, : len(r.pages)] = r.pages
        pids = np.asarray([r.pages[p // page] for r, p in zip(rows, positions)], np.int32)
        return (tables, positions.astype(np.int32), pids,
                (positions % page).astype(np.int32))

    @torch.inference_mode()
    def decode_host_lane(self, rows: List[Request], *, lane: int = 1) -> np.ndarray:
        """One decode iteration over host-resident ``rows`` (one host lane):
        float32 logits [n, V].  The layer stack runs on the lane's own CUDA
        stream — projections and FFN on the card, attention through
        :meth:`_host_attention` — and never touches the device KV pool, so
        it is safe beside :meth:`decode_batch0` and any other lane.  Each
        concurrently running caller must use a distinct ``lane``."""
        dev, n = self.device, len(rows)
        D = _bucket(n)  # rows n..D-1 are padding (see decode)
        tokens = np.zeros((D,), np.int64)
        positions = np.zeros((D,), np.int64)
        tokens[:n] = [r.all_tokens[-1] for r in rows]
        positions[:n] = [r.kv_len for r in rows]
        meta = self._host_meta(rows, positions[:n], self.page)
        model = self.model
        with on_stream(self._lane_stream(lane)):
            x = model.embed_tokens(torch.from_numpy(tokens).to(dev))
            pos_t = torch.from_numpy(positions).to(dev)
            for li, blk in enumerate(model.layers):
                q, k, v = _in_row_slices(functools.partial(self._layer_pre, blk), x, pos_t)
                o = torch.zeros_like(q)
                o[:n] = self._host_attention(li, q[:n], k[:n], v[:n], meta, q.dtype,
                                             f"hostattn-lane{lane}")
                x = _in_row_slices(functools.partial(self._layer_post, blk), x, o)
            return _in_row_slices(model.final_logits, x)[:n].cpu().numpy()

    def submit_host_lane(self, rows: List[Request], *,
                         pre: Optional[Callable[[], None]] = None,
                         lane: int = 1) -> Future:
        """Launch one host lane on a dispatch thread; the future resolves to
        ``(logits [n, V], (start, end))`` perf_counter stamps.  ``pre`` runs
        on the lane thread before any page is read (the engine passes the
        lane-scoped swap-out join there)."""

        def run_lane() -> Tuple[np.ndarray, Tuple[float, float]]:
            tr = self.tracer
            track = f"host{lane - 1}"  # the engine's lane index li = lane - 1
            t0 = time.perf_counter()
            if pre is not None:
                j0 = time.perf_counter() if tr is not None else 0.0
                pre()
                if tr is not None:
                    tr.emit(track, "join_out", j0, time.perf_counter())
            c0 = time.perf_counter() if tr is not None else 0.0
            out = self.decode_host_lane(rows, lane=lane)
            # one read of the clock ends both the nested compute span and the
            # lane window the engine spans and accounts
            end = time.perf_counter()
            if tr is not None:
                tr.emit(track, "compute", c0, end, {"rows": len(rows)})
            return out, (t0, end)

        return self._lane_pool.submit(run_lane)

    def close(self, timeout: float = WAIT_TIMEOUT_S) -> None:
        """Stop the lane and shard threads (idempotent); each is joined with
        a timeout."""
        for h in self.host_shards:
            h.close()
        for pool in filter(None, (self._lane_pool, self._prefix_pool, self._shard_pool)):
            pool.shutdown(wait=False, cancel_futures=True)
            for t in list(getattr(pool, "_threads", ())):
                t.join(timeout)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def prefill(self, reqs: List[Request], to_host: List[bool],
                extras_fn: Optional[Callable] = None) -> np.ndarray:
        """Prefill ``reqs``, scattering K/V into the pages already
        allocated on ``req.pages`` in each request's pool.  Prefix-cache hits
        (``cached_len > 0``) take the suffix prefill over their cached prefix
        (:meth:`_prefill_cached`); the rest go through the cold path as one
        padded batch, with the model inputs ``extras_fn(reqs, S)`` returns
        for the padded length S (a vlm's ``patch_embeds``).  Returns
        first-token float32 logits [n, V]."""
        warm = [i for i, r in enumerate(reqs) if r.cached_len > 0]
        if not warm:
            return self._prefill_cold(reqs, to_host, extras_fn)
        cold = [i for i, r in enumerate(reqs) if r.cached_len <= 0]
        warm_logits = self._prefill_cached([reqs[i] for i in warm], [to_host[i] for i in warm])
        out = np.zeros((len(reqs), warm_logits.shape[-1]), np.float32)
        out[warm] = warm_logits
        if cold:
            out[cold] = self._prefill_cold([reqs[i] for i in cold], [to_host[i] for i in cold],
                                           extras_fn)
        return out

    @torch.inference_mode()
    def _prefill_cold(self, reqs: List[Request], to_host: List[bool],
                      extras_fn: Optional[Callable] = None) -> np.ndarray:
        """Cold prefill of ``reqs`` as one batch padded to the reference's
        length bucket (the flash prefill kernel once per layer).  The padded
        length is part of the result for a moe model (its capacity) and a
        vlm (its patches need S >= their count), so it is the reference's;
        the padding is a suffix, so a dense row's result does not depend on
        it.  Under gather-TP every shard runs the kernel over its heads and
        its K/V go into its KV heads of the pools.  Returns first-token
        float32 logits [n, V]."""
        n, page = len(reqs), self.page
        S = _bucket(max(r.prefill_len for r in reqs), 16)
        tokens = np.zeros((n, S), np.int64)
        lens = np.zeros((n,), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : r.prefill_len] = r.prefill_tokens
            lens[i] = r.prefill_len
        extras = extras_fn(reqs, S) if extras_fn else {}
        if self.tp > 1:
            if extras:
                raise NotImplementedError("prefill extras unsupported at tp>1")
            logits, cache = self.model.prefill(torch.from_numpy(tokens),
                                               true_lens=torch.from_numpy(lens),
                                               shards=self.tp_layers)
            parts = [(s, self.tp) for s in range(self.tp)]
            kv = list(zip(cache["k"], cache["v"]))  # per shard [L, n, S, KV/tp, hd]
        else:
            logits, cache = self.model.prefill(torch.from_numpy(tokens),
                                               true_lens=torch.from_numpy(lens), **extras)
            parts = [None]
            kv = [(cache["k"], cache["v"])]  # [L, n, S, KV, hd]
        for i, (r, host) in enumerate(zip(reqs, to_host)):
            npages = len(r.pages)
            s_pad = npages * page
            for part, (k_all, v_all) in zip(parts, kv):
                kr, vr = k_all[:, i], v_all[:, i]
                if s_pad > S:
                    pad = (0, 0, 0, 0, 0, s_pad - S)
                    kr = torch.nn.functional.pad(kr, pad)
                    vr = torch.nn.functional.pad(vr, pad)
                else:
                    kr, vr = kr[:, :s_pad], vr[:, :s_pad]
                kr = kr.reshape(kr.shape[0], npages, page, *kr.shape[2:])
                vr = vr.reshape(vr.shape[0], npages, page, *vr.shape[2:])
                if host:
                    self.pool.host.put_pages(r.pages, kr, vr, part)
                    # layer-wise PCIe copy of the freshly computed KV
                    self.pool.add_swap_bytes(2 * kr.numel() * self.pool.host.k.element_size())
                else:
                    self.pool.device.put_pages(r.pages, kr, vr, part)
        return logits.cpu().numpy()

    # ------------------------------------------------------------------
    # suffix prefill over a cached prefix (prefix cache)
    # ------------------------------------------------------------------
    def _prefill_cached(self, reqs: List[Request], to_host: List[bool]) -> np.ndarray:
        """Suffix-only prefill of prefix-cache hits.  ``req.pages`` holds the
        shared and copy-on-write prefix pages in the target pool, then the
        suffix pages.  Device rows gather their cached prefix from the device
        pool (:meth:`_prefill_cached_gather`); host rows are served in place
        (:meth:`_prefill_cached_host`): each layer's suffix queries go to the
        host, which computes flash partials over the prefix pages where they
        lie, so the prefix never crosses PCIe.  With rows of both kinds the
        host leg runs on a thread and stream of its own (not a host lane's,
        which may be busy with this step's decode), beside the gather on the
        engine thread (it never touches the device pool)."""
        host_idx = [i for i, h in enumerate(to_host) if h]
        gpu_idx = [i for i, h in enumerate(to_host) if not h]
        if not (host_idx and gpu_idx):
            if host_idx:
                return self._prefill_cached_host(reqs)
            return self._prefill_cached_gather(reqs)

        def host_leg() -> np.ndarray:
            with on_stream(self._lane_stream(0)):  # host lanes are 1, 2, ...; 0 is free
                return self._prefill_cached_host([reqs[i] for i in host_idx])

        fut = self._prefix_pool.submit(host_leg)
        out_g = self._prefill_cached_gather([reqs[i] for i in gpu_idx])
        out_h = fut.result(timeout=WAIT_TIMEOUT_S)
        out = np.zeros((len(reqs), out_h.shape[-1]), np.float32)
        out[host_idx] = out_h
        out[gpu_idx] = out_g
        return out

    def _suffix_inputs(self, reqs: List[Request]):
        """Suffix tokens [n, S] (padded), suffix lengths, prefix lengths and
        the prefix page tables [n, T] (T = the longest prefix's pages; the
        padding is masked by the prefix lengths)."""
        n, page = len(reqs), self.page
        S = _bucket(max(r.suffix_len for r in reqs), 16)  # the reference's (moe capacity)
        tokens = np.zeros((n, S), np.int64)
        suffix_lens = np.zeros((n,), np.int32)
        prefix_lens = np.zeros((n,), np.int32)
        tables = np.zeros((n, max(-(-r.cached_len // page) for r in reqs)), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : r.suffix_len] = r.prefill_tokens[r.cached_len:]
            suffix_lens[i] = r.suffix_len
            prefix_lens[i] = r.cached_len
            npg = -(-r.cached_len // page)
            tables[i, :npg] = r.pages[:npg]
        return tokens, suffix_lens, prefix_lens, tables

    def _scatter_suffix(self, reqs: List[Request], k_all: torch.Tensor,
                        v_all: torch.Tensor, to_host: bool) -> None:
        """Token-granular write of each row's suffix K/V [L, n, S, KV, hd]
        at offset ``cached_len``, which may lie inside the copy-on-write
        page; into the host pool, the PCIe bytes of the copy are counted."""
        page = self.page
        pids: List[int] = []
        offs: List[int] = []
        for r in reqs:
            pos = range(r.cached_len, r.cached_len + r.suffix_len)
            pids += [r.pages[p // page] for p in pos]
            offs += [p % page for p in pos]
        k = torch.cat([k_all[:, i, : r.suffix_len] for i, r in enumerate(reqs)], dim=1)
        v = torch.cat([v_all[:, i, : r.suffix_len] for i, r in enumerate(reqs)], dim=1)
        pool = self.pool.host if to_host else self.pool.device
        pool.write_token_range(pids, offs, k, v)
        if to_host:  # layer-wise PCIe copy of the freshly computed K/V
            self.pool.add_swap_bytes(2 * k.numel() * self.pool.host.k.element_size())

    @torch.inference_mode()
    def _prefill_cached_gather(self, reqs: List[Request]) -> np.ndarray:
        """Device rows: gather each row's cached prefix pages from the
        device pool into [L, n, T, KV, hd] (T = the longest prefix's pages),
        prefill the suffix over it and write the suffix K/V into the device
        pool.  Under gather-TP this runs the unsharded weights on the primary
        device, as the reference's does, over the prefix gathered across the
        shards, and the suffix K/V are split into the shards' pools."""
        tokens, suffix_lens, prefix_lens, tables = self._suffix_inputs(reqs)
        pool = self.pool.device
        L, KV, hd = pool.num_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        T = tables.shape[1] * self.page
        pk, pv = pool.read_pages(tables)
        pk = pk.reshape(L, len(reqs), T, KV, hd)
        pv = pv.reshape(L, len(reqs), T, KV, hd)
        logits, k_all, v_all = self.model.prefill_with_prefix(
            torch.from_numpy(tokens), pk, pv, torch.from_numpy(prefix_lens),
            true_lens=torch.from_numpy(suffix_lens))
        self._scatter_suffix(reqs, k_all, v_all, to_host=False)
        return logits.cpu().numpy()

    def _host_prefix_cb(self, tables: np.ndarray, prefix_lens: np.ndarray, layer: int,
                        q: torch.Tensor):
        """One layer's prefix partials on the host: the suffix queries come
        over from the card, :meth:`HostAttention.prefix_partials` reads the
        prefix pages in place.  Traced as span ``L{layer}`` on
        ``hostattn-prefix``."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        out = self.host.prefix_partials(layer, q.float().cpu().numpy(), tables, prefix_lens)
        if tr is not None:
            tr.emit("hostattn-prefix", f"L{layer}", t0, time.perf_counter(),
                    {"rows": int(tables.shape[0])})
        return out

    def _host_prefix_cb_tp(self, tables: np.ndarray, prefix_lens: np.ndarray, layer: int,
                           qs: List[torch.Tensor]):
        """:meth:`_host_prefix_cb` under gather-TP: each shard's queries
        (its heads) go to the host, and the shards' HostAttention instances
        compute their partials over their KV heads concurrently on the shard
        threads, each traced on ``hostattn-prefix-s{shard}``."""

        def shard_partials(s: int, q: np.ndarray):
            tr = self.tracer
            t0 = time.perf_counter() if tr is not None else 0.0
            out = self.host_shards[s].prefix_partials(layer, q, tables, prefix_lens)
            if tr is not None:
                tr.emit(f"hostattn-prefix-s{s}", f"L{layer}", t0, time.perf_counter(),
                        {"rows": int(tables.shape[0]), "shard": s})
            return out

        futs = [self._shard_pool.submit(shard_partials, s, q.float().cpu().numpy())
                for s, q in enumerate(qs)]
        return [f.result(timeout=WAIT_TIMEOUT_S) for f in futs]

    @torch.inference_mode()
    def _prefill_cached_host(self, reqs: List[Request]) -> np.ndarray:
        """Host rows, zero-copy: the cached prefix pages stay in the host
        pool and are read in place, at their absolute positions, by the
        per-layer callback; only the computed suffix K/V crosses PCIe (its
        write into the host pool).  Under gather-TP each shard takes its
        partials from its own HostAttention."""
        tokens, suffix_lens, prefix_lens, tables = self._suffix_inputs(reqs)
        cb = self._host_prefix_cb_tp if self.tp > 1 else self._host_prefix_cb
        logits, k_all, v_all = self.model.prefill_with_host_prefix(
            torch.from_numpy(tokens), torch.from_numpy(prefix_lens),
            prefix_cb=functools.partial(cb, tables, prefix_lens),
            true_lens=torch.from_numpy(suffix_lens), shards=self.tp_layers)
        self._scatter_suffix(reqs, k_all, v_all, to_host=True)
        return logits.cpu().numpy()


# ---------------------------------------------------------------------------
# Contiguous slot executor (ssm / hybrid / audio; device-only)
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
    def prefill(self, req: Request, slot: int,
                extras: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """Prefill ``req`` alone, with its model inputs ``extras`` (each
        [1, ...]: an encoder-decoder's ``frames``), and insert its cache into
        ``slot``, zero-padded to the slot's shape (an encoder memory shorter
        than ``encoder_memory_len``; its ``enc_lens`` stays the frames
        given); returns its first-token float32 logits [V]."""
        tokens = torch.tensor([req.prefill_tokens], dtype=torch.long, device=self.device)
        inputs = {k: torch.as_tensor(v).to(self.device) for k, v in (extras or {}).items()}
        logits, one = self.model.prefill(tokens, capacity=self.capacity, **inputs)
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
