"""Host-side paged decode attention — the paper's CPU attention kernel
(PACPU, §4 "Efficient CPU Kernels"), a numpy copy of the JAX package's
``HostAttention``.

It reads the host pool through a zero-copy numpy view of the pinned torch
tensor (:class:`~repro_torch.core.kv_cache.PagePool`), so pages swapped in by
torch copies are visible here without another copy.  The kernel's
properties, as in the reference:

* **paged KV** (vLLM-style block tables);
* **flash-decoding split**: each request's KV is cut into page-granular
  tasks and the partial softmax results are merged with the (m, l, acc)
  log-sum-exp combine;
* **GQA aware**: scores are computed per KV head over its query group.

The executor hands it each layer's host rows explicitly (TrQKV → CPU attn
→ TrO).  :meth:`HostAttention.prefix_partials` serves the prefix cache's
zero-copy host path: flash partials of a suffix prefill's queries over a
host-resident cached prefix, read in place.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import ArchConfig


def _merge_partials(parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]):
    """Combine flash partials [(acc [H,hd], l [H], m [H]), ...] -> out [H,hd]."""
    m = np.max(np.stack([p[2] for p in parts]), axis=0)  # [H]
    num = np.zeros_like(parts[0][0])
    den = np.zeros_like(parts[0][1])
    for acc, l, mp in parts:
        corr = np.exp(mp - m)  # [H]
        num += acc * corr[:, None]
        den += l * corr
    return num / np.maximum(den, 1e-30)[:, None]


class HostAttention:
    """Paged decode attention over the host KV pool.

    ``pool_k`` / ``pool_v``: numpy views, shape [L, P, page, KV, hd], of
    the ``PagePool(backend="host")`` tensors (float16 or float32).
    """

    def __init__(self, cfg: ArchConfig, pool_k: np.ndarray, pool_v: np.ndarray,
                 threads: int = 1, split_pages: int = 32):
        self.cfg = cfg
        self.pool_k = pool_k
        self.pool_v = pool_v
        self.page = pool_k.shape[2]
        self.threads = max(1, threads)
        self.split_pages = split_pages  # flash-decoding task granularity
        self._tp: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.threads) if self.threads > 1 else None
        )
        # instrumentation (perf-model calibration + paper §5.5 bandwidth
        # study); lock-protected because worker threads update it
        self.busy_time = 0.0
        self.bytes_read = 0
        # zero-copy host-prefix gathers (suffix prefill over an in-place
        # host-resident prefix), kept apart from busy_time so the perf
        # model's cpu_attn calibration sees decode attention only; this pair
        # backs PerfModel.t_host_prefix
        self.prefix_busy_time = 0.0
        self.prefix_bytes_read = 0
        self._acct_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _row_attention(self, layer: int, q_row: np.ndarray, table: np.ndarray,
                       n_tokens: int, window: int = 0) -> np.ndarray:
        """One request row: q_row [H, hd]; table [n_pages]; attend over
        ``n_tokens`` cached tokens (the new token must already be written)."""
        H, hd = q_row.shape
        KV = self.pool_k.shape[3]
        qpk = H // KV
        scale = 1.0 / np.sqrt(hd)
        n_pages = -(-n_tokens // self.page)
        start_tok = 0
        if window and n_tokens > window:
            start_tok = n_tokens - window
        first_page = start_tok // self.page

        qg = q_row.reshape(KV, qpk, hd)
        parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for p0 in range(first_page, n_pages, self.split_pages):
            p1 = min(p0 + self.split_pages, n_pages)
            ids = table[p0:p1]
            k = self.pool_k[layer, ids].reshape(-1, KV, hd)  # [T, KV, hd]
            v = self.pool_v[layer, ids].reshape(-1, KV, hd)
            lo, hi = p0 * self.page, min(p1 * self.page, n_tokens)
            k, v = k[: hi - lo], v[: hi - lo]
            with self._acct_lock:
                self.bytes_read += k.nbytes + v.nbytes
            s = np.einsum("kqd,tkd->kqt", qg, k, optimize=True) * scale  # [KV,qpk,T]
            if lo < start_tok:
                s[:, :, : start_tok - lo] = -np.inf
            m = np.max(s, axis=-1)  # [KV, qpk]
            e = np.exp(s - m[..., None])
            l = np.sum(e, axis=-1)
            acc = np.einsum("kqt,tkd->kqd", e, v, optimize=True)
            parts.append((acc.reshape(H, hd), l.reshape(H), m.reshape(H)))
        if not parts:
            return np.zeros((H, hd), np.float32)
        return _merge_partials(parts).astype(np.float32)

    # ------------------------------------------------------------------
    def append_tokens(self, layer: int, rows: np.ndarray, k_new: np.ndarray,
                      v_new: np.ndarray, page_ids: np.ndarray, offsets: np.ndarray) -> None:
        """Write one new KV token per (host) row into the host pool."""
        if len(rows) == 0:
            return
        self.pool_k[layer, page_ids, offsets] = k_new[rows]
        self.pool_v[layer, page_ids, offsets] = v_new[rows]

    def run_layer(
        self,
        layer: int,
        q: np.ndarray,  # [D, H, hd] — all rows; we compute host rows only
        k_new: np.ndarray,  # [D, KV, hd]
        v_new: np.ndarray,
        *,
        host_rows: np.ndarray,  # [R] int indices into D
        tables: np.ndarray,  # [R, MP] page ids in the HOST pool
        lens: np.ndarray,  # [R] tokens valid BEFORE the append
        page_ids: np.ndarray,  # [R] page for the new token
        offsets: np.ndarray,  # [R]
        window: int = 0,
    ) -> np.ndarray:
        """Append new KV for host rows and attend; returns [D, H, hd] float32
        with zeros in non-host rows."""
        D, H, hd = q.shape
        out = np.zeros((D, H, hd), np.float32)
        if len(host_rows) == 0:
            return out
        t0 = time.perf_counter()
        self.append_tokens(layer, host_rows, k_new.astype(np.float32),
                           v_new.astype(np.float32), page_ids, offsets)
        q32 = q.astype(np.float32)

        def work(i: int) -> None:
            r = host_rows[i]
            out[r] = self._row_attention(layer, q32[r], tables[i], int(lens[i]) + 1, window)

        if self._tp is not None and len(host_rows) > 1:
            list(self._tp.map(work, range(len(host_rows))))
        else:
            for i in range(len(host_rows)):
                work(i)
        with self._acct_lock:
            self.busy_time += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # zero-copy host serving: prefix partials for the suffix prefill
    # ------------------------------------------------------------------
    def prefix_partials(
        self,
        layer: int,
        q: np.ndarray,  # [B, S, H, hd] suffix queries (padded rows allowed)
        tables: np.ndarray,  # [B, MP] page ids in the HOST pool
        prefix_lens: np.ndarray,  # [B] valid cached-prefix tokens per row
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flash partials of suffix queries over host-resident prefix pages,
        read in place at their absolute positions: the cached prefix never
        crosses PCIe, only these partials go back to the card, where
        :func:`repro_torch.models.attention.suffix_attention_merge` combines
        them with the causal suffix scores.  Rows with ``prefix_lens == 0``
        return ``m = -1e30`` so the merge discards them.  Returns
        ``(acc [B,S,H,hd], l [B,S,H], m [B,S,H])`` float32."""
        B, S, H, hd = q.shape
        KV = self.pool_k.shape[3]
        qpk = H // KV
        scale = 1.0 / np.sqrt(hd)
        acc = np.zeros((B, S, H, hd), np.float32)
        l = np.zeros((B, S, H), np.float32)
        m = np.full((B, S, H), -1e30, np.float32)
        t0 = time.perf_counter()
        for b in range(B):
            T = int(prefix_lens[b])
            if T <= 0:
                continue
            ids = tables[b, : -(-T // self.page)]
            k = self.pool_k[layer, ids].reshape(-1, KV, hd)[:T]
            v = self.pool_v[layer, ids].reshape(-1, KV, hd)[:T]
            with self._acct_lock:
                # DRAM bytes at the pool's dtype, before the f32 cast (the
                # decode path's bytes_read convention)
                self.prefix_bytes_read += k.nbytes + v.nbytes
            k = k.astype(np.float32)
            v = v.astype(np.float32)
            qg = q[b].astype(np.float32).reshape(S, KV, qpk, hd)
            s = np.einsum("skqd,tkd->skqt", qg, k, optimize=True) * scale
            mb = np.max(s, axis=-1)  # [S, KV, qpk]
            e = np.exp(s - mb[..., None])
            acc[b] = np.einsum("skqt,tkd->skqd", e, v, optimize=True).reshape(S, H, hd)
            l[b] = np.sum(e, axis=-1).reshape(S, H)
            m[b] = mb.reshape(S, H)
        with self._acct_lock:
            self.prefix_busy_time += time.perf_counter() - t0
        return acc, l, m

    def close(self) -> None:
        if self._tp is not None:
            self._tp.shutdown(wait=True)
