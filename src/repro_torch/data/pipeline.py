"""Deterministic synthetic token pipeline, the port of the JAX package's
``data/pipeline.py``.

Batch ``i`` is a pure function of ``(seed, i)`` through a counter-based RNG
(Philox), bit for bit the reference's numpy arrays, so a restarted job
resumes the exact data stream from any step.  Tokens are Zipf-distributed
with a Markov blend (75% of positions follow a per-seed successor table),
so the LM loss really decreases.  A one-deep prefetch thread builds the
next batch's numpy arrays while the device steps; the consumer moves the
tensors to its own device.
"""

from __future__ import annotations

import threading
from queue import Empty, Queue
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.config import ArchConfig


class SyntheticTokens:
    def __init__(self, cfg: ArchConfig, *, batch: int, seq_len: int, seed: int = 0,
                 zipf_a: float = 1.2):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.zipf_a = zipf_a
        # fixed per-seed Markov successor table: makes tokens predictable
        rng = np.random.default_rng(np.random.Philox(key=seed))
        self._succ = rng.integers(1, cfg.vocab_size, size=cfg.vocab_size, dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): ``tokens``, ``targets`` [B, S]
        int32, ``loss_mask`` [B, S] float32, and a vlm's ``patch_embeds``
        [B, P, d] or an encoder-decoder's ``frames`` [B, F, d] float32."""
        rng = np.random.default_rng(np.random.Philox(key=self.seed, counter=step))
        B, S, V = self.batch, self.seq_len, self.cfg.vocab_size
        base = rng.zipf(self.zipf_a, size=(B, S)).clip(1, V - 1).astype(np.int64)
        follow = rng.random((B, S)) < 0.75
        toks = base.copy()
        for s in range(1, S):
            toks[:, s] = np.where(follow[:, s], self._succ[toks[:, s - 1]], base[:, s])
        tokens = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "tokens": np.pad(tokens, [(0, 0), (0, 1)])[:, :S],
            "targets": np.pad(targets, [(0, 0), (0, 1)])[:, :S],
            "loss_mask": np.ones((B, S), np.float32),
        }
        # modality extras (stubbed frontends)
        if self.cfg.modality is not None and self.cfg.modality.num_embeds:
            out["patch_embeds"] = rng.standard_normal(
                (B, self.cfg.modality.num_embeds, self.cfg.d_model)).astype(np.float32)
        if self.cfg.has_encoder:
            F = min(self.cfg.encdec.encoder_memory_len, S)
            out["frames"] = rng.standard_normal((B, F, self.cfg.d_model)).astype(np.float32)
        return out


def as_tensors(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays as tensors on ``device`` (the CPU when None)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_batches(source: SyntheticTokens, *, start_step: int = 0, prefetch: bool = True
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Iterator over the batches from ``start_step`` on, as CPU tensors,
    with the next one built on a background thread (``prefetch``)."""
    if not prefetch:
        step = start_step
        while True:
            yield as_tensors(source.batch_at(step))
            step += 1

    q: Queue = Queue(maxsize=2)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(source.batch_at(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield as_tensors(q.get())
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except Empty:
                pass
            t.join(0.01)
