"""Workload traces (§5.1).

Two real-world-shaped generators and the paper's synthetic sweep:

* :func:`azure_code_trace` — AC-like: the Azure LLM coding trace has long
  prompts (median ≈ 2k tokens, heavy tail) and short-to-medium outputs.
  Distribution parameters follow the published trace statistics
  (Patel et al., Splitwise, ISCA'24: coding input mean ≈ 2000, output ≈ 30).
* :func:`osc_trace` — OSC-like: OpenAI summarize-comparisons; shorter prompts
  (few hundred tokens) and short summaries.
* :func:`synthetic_trace` — (l_i, l_o) pairs with lengths sampled uniformly
  from [0.9 l, 1.1 l] exactly as §5.1.

Arrival timestamps follow a Poisson process (§5.2).  All generators are
deterministic given a seed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class TraceRequest:
    arrival_time: float
    prompt_len: int
    output_len: int
    prompt: Optional[List[int]] = None  # token ids (real-engine runs)
    conv: Optional[int] = None  # conversation id (multiturn traces)

    def materialise(self, rng: np.random.Generator, vocab: int) -> "TraceRequest":
        if self.prompt is None:
            self.prompt = list(map(int, rng.integers(1, vocab, size=self.prompt_len)))
        return self


def poisson_arrivals(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """n arrival timestamps of a Poisson process with `rate` req/s."""
    if rate <= 0:
        return np.zeros(n)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def _lognormal_lengths(rng, n, median, sigma, lo, hi):
    vals = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(vals, lo, hi).astype(int)


def azure_code_trace(
    n: int, rate: float, *, seed: int = 0,
    prompt_median: int = 1800, output_median: int = 28,
    max_prompt: int = 7500, max_output: int = 1000,
) -> List[TraceRequest]:
    rng = np.random.default_rng(seed)
    arr = poisson_arrivals(n, rate, rng)
    p = _lognormal_lengths(rng, n, prompt_median, 0.9, 32, max_prompt)
    o = _lognormal_lengths(rng, n, output_median, 1.1, 4, max_output)
    return [TraceRequest(float(a), int(pi), int(oi)) for a, pi, oi in zip(arr, p, o)]


def osc_trace(
    n: int, rate: float, *, seed: int = 0,
    prompt_median: int = 380, output_median: int = 32,
    max_prompt: int = 2000, max_output: int = 250,
) -> List[TraceRequest]:
    rng = np.random.default_rng(seed)
    arr = poisson_arrivals(n, rate, rng)
    p = _lognormal_lengths(rng, n, prompt_median, 0.6, 16, max_prompt)
    o = _lognormal_lengths(rng, n, output_median, 0.7, 4, max_output)
    return [TraceRequest(float(a), int(pi), int(oi)) for a, pi, oi in zip(arr, p, o)]


def synthetic_trace(
    n: int, rate: float, input_len: int, output_len: int, *, seed: int = 0
) -> List[TraceRequest]:
    """§5.1: lengths uniform in [0.9l, 1.1l], independent."""
    rng = np.random.default_rng(seed)
    arr = poisson_arrivals(n, rate, rng)
    p = rng.integers(int(0.9 * input_len), int(1.1 * input_len) + 1, size=n)
    o = rng.integers(max(1, int(0.9 * output_len)), int(1.1 * output_len) + 1, size=n)
    return [TraceRequest(float(a), int(pi), int(oi)) for a, pi, oi in zip(arr, p, o)]


def multiturn_trace(
    n: int, rate: float, *, seed: int = 0,
    turns: int = 4,
    system_len: int = 192,
    context_len: int = 64,
    user_len_median: int = 48,
    output_median: int = 24,
    max_output: int = 128,
    think_time: float = 1.0,
    vocab: int = 500,
) -> List[TraceRequest]:
    """Shared-system-prompt multi-turn conversations (§5.1 style).

    ``n`` requests across ``ceil(n / turns)`` conversations.  Every
    conversation's prompts start with ONE fleet-wide system prompt
    (``system_len`` tokens, identical across conversations), followed by a
    per-conversation context block, and each turn appends that turn's user
    message — so turn ``k``'s prompt is a strict prefix-extension of turn
    ``k-1``'s.  Prompts are materialised here (token ids in [1, vocab)) so a
    prefix cache sees real shared pages.  Conversation starts follow a
    Poisson process at ``rate / turns`` conversations/s; turns within a
    conversation are spaced by exponential think time.
    """
    rng = np.random.default_rng(seed)
    n_conv = -(-n // turns)
    system = list(map(int, rng.integers(1, vocab, size=system_len)))
    starts = poisson_arrivals(n_conv, rate / max(turns, 1), rng)
    out: List[TraceRequest] = []
    for c in range(n_conv):
        history = system + list(map(int, rng.integers(1, vocab, size=context_len)))
        t = float(starts[c])
        for _ in range(turns):
            if len(out) >= n:
                break
            user = _lognormal_lengths(rng, 1, user_len_median, 0.5, 8, 4 * user_len_median)[0]
            history = history + list(map(int, rng.integers(1, vocab, size=int(user))))
            olen = _lognormal_lengths(rng, 1, output_median, 0.7, 4, max_output)[0]
            out.append(TraceRequest(t, len(history), int(olen),
                                    prompt=list(history), conv=c))
            t += think_time + float(rng.exponential(think_time))
    out.sort(key=lambda r: r.arrival_time)
    return out


def save_trace(trace: List[TraceRequest], path: str) -> None:
    """Write a trace as JSONL for later replay (arrival_time/prompt_len/
    output_len per line; materialised prompts and conv ids round-trip too)."""
    with open(path, "w") as f:
        for r in trace:
            rec = {
                "arrival_time": r.arrival_time,
                "prompt_len": r.prompt_len,
                "output_len": r.output_len,
            }
            if r.prompt is not None:
                rec["prompt"] = r.prompt
            if r.conv is not None:
                rec["conv"] = r.conv
            f.write(json.dumps(rec) + "\n")


def replay_trace(path: str, n: int = 0, *, time_scale: float = 1.0) -> List[TraceRequest]:
    """Replayed arrivals from a JSONL file (one request per line, as written
    by :func:`save_trace`).  ``n > 0`` truncates; ``time_scale`` stretches or
    compresses the recorded inter-arrival gaps (0.5 = replay at 2x rate)."""
    out: List[TraceRequest] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.append(TraceRequest(
                float(rec["arrival_time"]) * time_scale,
                int(rec["prompt_len"]),
                int(rec["output_len"]),
                prompt=rec.get("prompt"),
                conv=rec.get("conv"),
            ))
            if n > 0 and len(out) >= n:
                break
    out.sort(key=lambda r: r.arrival_time)
    return out


TRACES = {
    "ac": azure_code_trace,
    "osc": osc_trace,
    "multiturn": multiturn_trace,
}


def get_trace(name: str, n: int, rate: float, seed: int = 0) -> List[TraceRequest]:
    if name in TRACES:
        return TRACES[name](n, rate, seed=seed)
    if name.startswith("multiturn:"):  # "multiturn:4" = 4 turns/conversation
        return multiturn_trace(n, rate, seed=seed, turns=int(name.split(":")[1]))
    if name.startswith("syn:"):  # "syn:1000x100"
        li, lo = name[4:].split("x")
        return synthetic_trace(n, rate, int(li), int(lo), seed=seed)
    if name.startswith("replay:"):  # "replay:/path/to/trace.jsonl"
        return replay_trace(name.split(":", 1)[1], n)
    raise KeyError(
        f"unknown trace {name!r} "
        "(have ac, osc, multiturn[:turns], syn:<in>x<out>, replay:<path>)"
    )
