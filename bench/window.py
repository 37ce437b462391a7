"""What a run records in its measured window, and the arithmetic over it.

The percentile is ``ServeMetrics``'s (``src/repro_torch/serving/metrics.py``:
``np.percentile``, linear interpolation), applied to the window alone and
not to a run to completion:

* tokens a second: every token emitted inside the window over its length;
* time to first token: over every request due inside the window, due time to
  first token; one still waiting when the window closes counts its wait so
  far;
* time per output token: over every request that emitted two tokens or more
  inside the window, (last - first token time) / (tokens - 1), both inside.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def percentile(vals: List[float], pct: float) -> Optional[float]:
    if not vals:
        return None
    return float(np.percentile(vals, pct))


@dataclass
class Rec:
    """One request as the benchmark saw it (host clock, perf_counter)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    due: float
    submitted: float
    first: Optional[float] = None
    finished: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    host_tokens: int = 0
    preempted: bool = False
    batch_len: int = 0  # the longest prefill of the batch it was prefilled in
    win_n: int = 0
    win_first: Optional[float] = None
    win_last: Optional[float] = None


@dataclass
class Step:
    """One engine step: its host-clock window and the work it did, as read
    from the requests' state after it."""

    t0: float
    t1: float
    dev_ctx: List[int]  # device decode rows: tokens each attended over
    host_ctx: List[int]  # host decode rows
    prefill_lens: List[int]  # rows prefilled (a replay's tokens as one row)


@dataclass
class Window:
    t0: float
    t1: float = 0.0
    steps: List[Step] = field(default_factory=list)
    tokens: int = 0
    lateness: List[float] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def ttft_samples(recs: Dict[int, Rec], win: Window) -> List[float]:
    out = []
    for r in recs.values():
        if win.t0 <= r.due < win.t1:
            first = r.first if r.first is not None and r.first <= win.t1 else win.t1
            out.append(first - r.due)
    return out


def tpot_samples(recs: Dict[int, Rec]) -> List[float]:
    return [(r.win_last - r.win_first) / (r.win_n - 1)
            for r in recs.values() if r.win_n >= 2]
