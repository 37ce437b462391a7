"""How noisy the tracing A/B is, and what its re-measure reads: ``--runs``
fastdecode bursts (``engine_real.run``'s, ``--n`` rows) alternating
untraced and traced, then the re-measure's two runs tracing alternate
steps.  The summary holds every untraced/traced pair's whole-run overhead
(the tracing gate's first look), the re-measure's estimator
(``engine_real._interleaved_overhead``) over every ordered pair of the
alternating runs, whose true value is 0 (both halves of a step index ran
under the same tracing) so that its spread is its noise, and the
re-measure's own reading.  Not one of the reference's benchmarks: the
port's check of the estimator its tracing gate falls back on.  One JSON
line per run, then a summary line.

  PYTHONPATH=src python -m repro_torch.benchmarks.tracing_ab --runs 10 --ewma-alpha 0
  PYTHONPATH=src python -m repro_torch.benchmarks.tracing_ab --smoke --device cpu --runs 4
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import List

from repro_torch.benchmarks import engine_real
from repro_torch.benchmarks.common import add_engine_args, card_line, engine_opts

GATE = 0.05  # bench_trend's TRACING_OVERHEAD_TOL


def spread(values: List[float]) -> dict:
    return {"min": round(min(values), 4), "max": round(max(values), 4),
            "over_gate": sum(v > GATE for v in values), "of": len(values)}


def collect(runs: int, n: int, log=print, **opts) -> dict:
    """``runs`` bursts, untraced first, then alternating; returns the
    summary (each run's tok/s by side, the two estimators' spreads)."""
    done = []
    for i in range(runs):
        traced = i % 2 == 1
        r, _ = engine_real.run("fastdecode", n, pipeline=True, microbatch=True,
                               tracing=traced, **opts)
        done.append((traced, r))
        log(json.dumps({"run": i, "traced": traced, "tok_s": r["token_throughput"],
                        "wall_s": r["wall_s"], "steps": len(r.step_times)}))
    halves = []
    for parity in (0, 1):
        r, _ = engine_real.run("fastdecode", n, pipeline=True, microbatch=True,
                               trace_parity=parity, **opts)
        halves.append(r)
        log(json.dumps({"run": f"traced on {('even', 'odd')[parity]} steps",
                        "tok_s": r["token_throughput"], "wall_s": r["wall_s"],
                        "steps": len(r.step_times)}))
    offs = [r for t, r in done if not t]
    ons = [r for t, r in done if t]
    whole = [engine_real._overhead(a, b) for a in offs for b in ons]
    interleaved = [engine_real._interleaved_overhead(a.step_times, b.step_times)
                   for (_, a), (_, b) in itertools.permutations(done, 2)]
    return {"untraced_tok_s": [r["token_throughput"] for r in offs],
            "traced_tok_s": [r["token_throughput"] for r in ons],
            "whole_run_pairs": spread(whole), "interleaved_pairs": spread(interleaved),
            "remeasure": round(engine_real._interleaved_overhead(
                halves[0].step_times, halves[1].step_times), 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--n", type=int, default=3, help="rows of the fastdecode burst")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    summary = collect(args.runs, args.n, **engine_opts(args))
    dev = args.device
    if dev is None or str(dev).startswith("cuda"):
        summary["card"] = card_line()
    print(json.dumps({"tracing_ab": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
