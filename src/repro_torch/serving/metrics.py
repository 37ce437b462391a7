"""Serving metrics.

The paper's headline metric (Fig. 6): **average per-token latency** — each
request's full latency divided by its output token count, averaged over
requests.  Throughput = completed tokens / makespan.

Online-serving additions: per-request TTFT (time to first token) and TPOT
(time per output token after the first) with p50/p99 percentiles, and
**goodput** — finished requests per second that met the TTFT/TPOT SLOs —
the headline metric of the open-loop arrival-driven loop (`launch/serve.py
run_online`), where admission-rejected and still-queued requests count
against SLO attainment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def _finite(x: float, nd: int) -> Optional[float]:
    """Round ``x`` for the summary dict, mapping non-finite values (no
    finished requests -> nan percentiles) to ``None`` so ``json.dump``
    emits valid JSON (nan is rejected by strict parsers and
    ``allow_nan=False``)."""
    if not math.isfinite(x):
        return None
    return round(x, nd)


@dataclass
class RequestRecord:
    rid: int
    arrival_time: float
    prompt_len: int
    output_len: int
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # terminal state: "active" (still in flight / never finished),
    # "finished", "rejected" (admission control bounced the offer; rid is
    # -1 — the engine never assigned one), or "cancelled" (client
    # departure mid-flight).  Rejected/cancelled records keep goodput
    # denominators and the request-lifecycle traces honest.
    status: str = "active"
    reject_reason: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def per_token_latency(self) -> Optional[float]:
        lat = self.latency
        if lat is None or self.output_len == 0:
            return None
        return lat / self.output_len

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token AFTER the first (decode cadence; None for
        single-token outputs, which have no decode phase to pace)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.output_len <= 1:
            return None
        return (self.finish_time - self.first_token_time) / (self.output_len - 1)


@dataclass
class ServeMetrics:
    records: List[RequestRecord] = field(default_factory=list)
    makespan: float = 0.0
    iterations: int = 0
    mode_counts: Dict[str, int] = field(default_factory=dict)
    swap_bytes: int = 0
    offloaded_decodes: int = 0
    device_decodes: int = 0
    # measured pipeline overlap (engine EngineStats mirror)
    host_busy_time: float = 0.0
    device_busy_time: float = 0.0
    pipeline_overlap_time: float = 0.0
    bubble_fraction: float = 0.0
    swap_hidden_bytes: int = 0
    swap_wait_time: float = 0.0
    # unified lane plans: batch-1-only micro-batch splits, mixed-plan lane
    # borrowing, and the per-K step histogram (EngineStats mirror)
    microbatched_steps: int = 0
    serial_b1_steps: int = 0
    borrowed_lane_steps: int = 0
    lane_count_steps: Dict[int, int] = field(default_factory=dict)
    lane_busy: Dict[str, float] = field(default_factory=dict)
    # prefix cache (PrefixCacheStats mirror; zeros when the cache is off)
    prefill_tokens_computed: int = 0
    prefix_hit_rate: float = 0.0
    prefix_hits: int = 0
    prefix_lookups: int = 0
    prefix_hit_tokens: int = 0
    prefix_promoted_pages: int = 0
    prefix_demoted_pages: int = 0
    prefix_evicted_pages: int = 0
    prefix_cow_copies: int = 0
    # zero-copy host-tier serving: cpu-placed rows whose host-resident
    # prefix was pinned in place (no promotion PCIe), the hit tokens served
    # that way, and the host-resident prefix bytes that DID cross PCIe
    inplace_host_hits: int = 0
    host_served_hit_tokens: int = 0
    host_hit_pcie_bytes: int = 0
    # plan-ahead scheduling (EngineStats mirror): speculative plans adopted,
    # plans invalidated by arrivals/eos/preemption, speculation rounds skipped,
    # critical-path plan time, and plan time hidden behind lane execution
    planahead_hits: int = 0
    planahead_replans: int = 0
    planahead_skipped: int = 0
    plan_busy_time: float = 0.0
    planahead_hidden_time: float = 0.0
    # open-loop admission control: requests refused at offer() time
    rejected_requests: int = 0
    # speculative decoding (EngineStats mirror; zeros when --spec-decode is
    # off): chained-verify steps run, drafts proposed/accepted/rejected,
    # wall time spent in verify passes, and the accepted-length histogram
    # (accepted-run length per speculated row per step)
    spec_steps: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rejected_drafts: int = 0
    spec_busy_time: float = 0.0
    accept_len_hist: Dict[int, int] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def finished(self) -> List[RequestRecord]:
        """Completed requests (cancelled ones record a departure time for
        bookkeeping but never count as finished work)."""
        return [r for r in self.records
                if r.finish_time is not None and r.status != "cancelled"]

    @property
    def terminal_counts(self) -> Dict[str, int]:
        """Every record bucketed by terminal state — the goodput
        denominator story: finished + active + rejected + cancelled ==
        len(records)."""
        counts = {"finished": 0, "active": 0, "rejected": 0, "cancelled": 0}
        for r in self.records:
            if r.status in ("rejected", "cancelled"):
                counts[r.status] += 1
            elif r.finish_time is not None:
                counts["finished"] += 1
            else:
                counts["active"] += 1
        return counts

    @property
    def reject_reasons(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            if r.status == "rejected":
                key = r.reject_reason or "unknown"
                out[key] = out.get(key, 0) + 1
        return out

    def record_rejection(self, arrival_time: float, prompt_len: int,
                         output_len: int,
                         reason: str = "max_waiting") -> RequestRecord:
        """Record an admission-rejected offer (rid -1: the engine never
        assigned one) so it stops vanishing from the request ledger."""
        rec = RequestRecord(-1, arrival_time, prompt_len, output_len,
                            status="rejected", reject_reason=reason)
        self.records.append(rec)
        return rec

    def record_cancelled(self, rid: int,
                         finish_time: Optional[float] = None) -> bool:
        """Mark the record for ``rid`` as cancelled (client departure);
        returns False when no such record exists."""
        for r in self.records:
            if r.rid == rid and r.status not in ("finished", "rejected"):
                r.status = "cancelled"
                if finish_time is not None and r.finish_time is None:
                    r.finish_time = finish_time
                return True
        return False

    @property
    def total_output_tokens(self) -> int:
        return sum(r.output_len for r in self.finished)

    @property
    def total_tokens(self) -> int:
        return sum(r.output_len + r.prompt_len for r in self.finished)

    @property
    def throughput(self) -> float:
        """Output tokens per second over the makespan."""
        if self.makespan <= 0:
            return 0.0
        return self.total_output_tokens / self.makespan

    @property
    def token_throughput(self) -> float:
        """(input+output) tokens per second — the paper's Fig. 10b metric."""
        if self.makespan <= 0:
            return 0.0
        return self.total_tokens / self.makespan

    def per_token_latency(self, pct: Optional[float] = None) -> float:
        vals = [r.per_token_latency for r in self.finished if r.per_token_latency is not None]
        if not vals:
            return float("nan")
        if pct is None:
            return float(np.mean(vals))
        return float(np.percentile(vals, pct))

    def latency_distribution(self) -> np.ndarray:
        return np.array(sorted(
            r.per_token_latency for r in self.finished if r.per_token_latency is not None
        ))

    def ttft(self, pct: Optional[float] = None) -> float:
        vals = [r.ttft for r in self.finished if r.ttft is not None]
        if not vals:
            return float("nan")
        return float(np.mean(vals) if pct is None else np.percentile(vals, pct))

    def tpot(self, pct: Optional[float] = None) -> float:
        vals = [r.tpot for r in self.finished if r.tpot is not None]
        if not vals:
            return float("nan")
        return float(np.mean(vals) if pct is None else np.percentile(vals, pct))

    def slo_attained(self, slo_ttft: float, slo_tpot: float) -> int:
        """Finished requests meeting BOTH SLOs.  A missing TPOT (single-token
        output) only has to meet the TTFT bound; a missing TTFT fails."""
        n = 0
        for r in self.finished:
            t = r.ttft
            if t is None or t > slo_ttft:
                continue
            p = r.tpot
            if p is not None and p > slo_tpot:
                continue
            n += 1
        return n

    def goodput(self, slo_ttft: float, slo_tpot: float) -> float:
        """SLO-attaining finished requests per second over the makespan.
        Rejected / unfinished requests simply never count in the numerator."""
        if self.makespan <= 0:
            return 0.0
        return self.slo_attained(slo_ttft, slo_tpot) / self.makespan

    def summary(self) -> Dict[str, float]:
        return {
            "requests": len(self.finished),
            "throughput_tok_s": round(self.throughput, 2),
            "token_throughput_tok_s": round(self.token_throughput, 2),
            "per_token_latency_ms": _finite(self.per_token_latency() * 1e3, 2),
            "p99_per_token_latency_ms": _finite(self.per_token_latency(99) * 1e3, 2),
            "ttft_s": _finite(self.ttft(), 3),
            "ttft_p50_ms": _finite(self.ttft(50) * 1e3, 2),
            "ttft_p99_ms": _finite(self.ttft(99) * 1e3, 2),
            "tpot_p50_ms": _finite(self.tpot(50) * 1e3, 2),
            "tpot_p99_ms": _finite(self.tpot(99) * 1e3, 2),
            "makespan_s": round(self.makespan, 2),
            "offload_frac": round(
                self.offloaded_decodes
                / max(1, self.offloaded_decodes + self.device_decodes),
                3,
            ),
            # realized (measured) asymmetric-pipeline overlap
            "host_busy_s": round(self.host_busy_time, 3),
            "device_busy_s": round(self.device_busy_time, 3),
            "overlap_s": round(self.pipeline_overlap_time, 3),
            "bubble_fraction": round(self.bubble_fraction, 3),
            "swap_hidden_MB": round(self.swap_hidden_bytes / 1e6, 3),
            "swap_wait_s": round(self.swap_wait_time, 3),
            # unified lane plans (0 when nothing was eligible)
            "microbatched_steps": self.microbatched_steps,
            "serial_b1_steps": self.serial_b1_steps,
            "borrowed_lane_steps": self.borrowed_lane_steps,
            "lane_count_steps": {str(k): v for k, v in
                                 sorted(self.lane_count_steps.items())},
            "lane_busy_s": {k: round(v, 3) for k, v in sorted(self.lane_busy.items())},
            # two-tier prefix cache (all zeros when disabled)
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "hit_rate": round(self.prefix_hit_rate, 3),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hits": self.prefix_hits,
            "prefix_lookups": self.prefix_lookups,
            "prefix_promoted_pages": self.prefix_promoted_pages,
            "prefix_demoted_pages": self.prefix_demoted_pages,
            "prefix_evicted_pages": self.prefix_evicted_pages,
            "prefix_cow_copies": self.prefix_cow_copies,
            # zero-copy host-tier serving
            "inplace_host_hits": self.inplace_host_hits,
            "host_served_hit_tokens": self.host_served_hit_tokens,
            "host_hit_pcie_MB": round(self.host_hit_pcie_bytes / 1e6, 3),
            # plan-ahead scheduling + open-loop admission
            "planahead_hits": self.planahead_hits,
            "planahead_replans": self.planahead_replans,
            "planahead_skipped": self.planahead_skipped,
            "plan_busy_s": round(self.plan_busy_time, 3),
            "planahead_hidden_s": round(self.planahead_hidden_time, 3),
            "rejected_requests": self.rejected_requests,
            # speculative decoding (all zeros when disabled)
            "spec_steps": self.spec_steps,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rejected_drafts": self.rejected_drafts,
            "spec_busy_s": round(self.spec_busy_time, 3),
            "accept_len_hist": {str(k): v for k, v in
                                sorted(self.accept_len_hist.items())},
            # terminal accounting: every offered request lands in exactly
            # one bucket (rejections/cancellations no longer vanish)
            "terminal_counts": self.terminal_counts,
            "reject_reasons": self.reject_reasons,
        }
