"""Request lifecycle for the online engine."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"  # in the prefill waitqueue
    RUNNING = "running"  # decoding (GPU or CPU runqueue, per `location`)
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_token: Optional[int] = None

    state: RequestState = RequestState.WAITING
    location: str = "gpu"  # where the KV cache lives: "gpu" | "cpu"
    out_tokens: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)  # page ids in current pool
    # Prefix-cache hit length (tokens served from cached KV pages; set by
    # NeoEngine.submit as a scheduler estimate, finalized at prefill
    # dispatch).  0 when the cache is disabled or misses.
    cached_len: int = 0
    # Residency of the longest cached prefix at submit time ("cpu" | "gpu" |
    # None on a miss) — "cpu" steers the scheduler toward host placement so
    # the prefix is served in place from DRAM (zero-copy host serving).
    prefix_loc: Optional[str] = None
    # modality-frontend extras (precomputed patch/frame embeddings)
    extras: Optional[Dict[str, Any]] = None
    # consecutive iterations the scheduler skipped this (host) request —
    # drives the anti-starvation override in step 4
    skipped: int = 0

    # metrics
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def kv_len(self) -> int:
        """Tokens currently IN the KV cache.

        After prefill the cache holds the prompt; the newest sampled token is
        in-flight (it is the token FED to the next decode step, whose KV gets
        written at position ``kv_len`` during that step).
        """
        if self.state == RequestState.WAITING:
            return 0
        return len(self.prompt) + max(0, len(self.out_tokens) - 1)

    @property
    def next_position(self) -> int:
        return self.kv_len

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt + self.out_tokens

    # -- recompute preemption ------------------------------------------------
    # When both pools are full the scheduler evicts a request's KV entirely
    # and re-prefills it later (vLLM "recompute" preemption).  The replayed
    # prefill covers everything EXCEPT the newest sampled token (which is the
    # in-flight input of the next decode step).
    @property
    def prefill_tokens(self) -> List[int]:
        if self.out_tokens:
            return self.prompt + self.out_tokens[:-1]
        return self.prompt

    @property
    def prefill_len(self) -> int:
        return len(self.prompt) + max(0, len(self.out_tokens) - 1)

    # -- prefix cache --------------------------------------------------------
    @property
    def suffix_len(self) -> int:
        """Prefill tokens actually computed (beyond the cached prefix)."""
        return self.prefill_len - min(self.cached_len, max(self.prefill_len - 1, 0))

    def new_prefill_pages(self, page_size: int) -> int:
        """Pages to allocate for prefill beyond the shared cached full pages
        (the copy-on-write page for a mid-page hit counts as new)."""
        total = -(-self.prefill_len // page_size)
        shared = min(self.cached_len, max(self.prefill_len - 1, 0)) // page_size
        return total - shared

    def is_done(self) -> bool:
        if len(self.out_tokens) >= self.max_new_tokens:
            return True
        return bool(self.out_tokens and self.eos_token is not None
                    and self.out_tokens[-1] == self.eos_token)

    def pages_needed(self, page_size: int, extra_tokens: int = 0) -> int:
        total = self.kv_len + extra_tokens
        return -(-total // page_size)
