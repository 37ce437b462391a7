"""The tracer's overhead on the card, measured in turns.

    PYTHONPATH=src python -m repro_torch.obs.overhead [--rounds 2]

Serves ``chip_smoke.py``'s pipelined qwen3-0.6b workload (full width, bf16,
random weights from seed 0, 8 requests of 256-768 prompt tokens and 32
outputs, all at t = 0, pools of 64 device and 512 host pages, the neo
policy) untraced and traced in turns, untraced, traced, traced, untraced per
round, in one process, so that the host's speed, which sets these makespans
(numpy host attention), drifts alike over both modes.  Every traced run
must give the untraced tokens and pass :func:`repro_torch.obs.reconcile`.
Then it times one :meth:`SpanTracer.emit` on this host.  Prints one JSON
line per run, then a summary line: per mode the median makespan, batch-0
lane, host-attention and device busy time, the traced/untraced ratio of the
medians, events per traced run and µs per emit, with the card's name and
power limit.  ``--smoke --device cpu`` runs the same on the CPU at the smoke
size (no card numbers).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def emit_cost_us(n: int = 200_000) -> float:
    """Median over 5 batches of the host time of one emit, in µs."""
    from repro_torch.obs.tracer import SpanTracer

    per = []
    for _ in range(5):
        tr = SpanTracer()
        t0 = time.perf_counter()
        for i in range(n):
            tr.emit("host0", "lane", 1.0, 2.0, {"iter": i})
        per.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(per)


def _trace(vocab: int, n: int = 8, seed: int = 0):
    from repro_torch.serving.traces import TraceRequest

    rng = np.random.default_rng(seed)
    trace = [TraceRequest(0.0, int(rng.integers(256, 769)), 32) for _ in range(n)]
    for t in trace:
        t.materialise(rng, vocab)
    return trace


def serve_once(cfg, device: str, tracing: bool) -> dict:
    """One closed-loop serve of the workload; returns its tokens, the
    makespan, lane and busy times, and the events the tracer recorded."""
    from repro_torch.config import EngineConfig
    from repro_torch.core.engine import NeoEngine
    from repro_torch.launch.serve import run_trace
    from repro_torch.obs.reconcile import reconcile

    ecfg = EngineConfig(device_pool_pages=64, host_pool_pages=512, policy="neo",
                        pipeline=True, hw_profile="h100_sxm", seed=0, tracing=tracing)
    engine = NeoEngine(cfg, ecfg, device=device)
    try:
        m = run_trace(engine, _trace(cfg.vocab_size), vocab=cfg.vocab_size)
    finally:
        engine.close()
    s = engine.stats
    if tracing:
        rep = reconcile(engine.tracer, s)
        if not rep.ok:
            raise AssertionError(f"reconcile failed: {rep.failed()}")
    return {"traced": tracing, "makespan_s": m.makespan,
            "batch0_s": s.lane_busy_time.get("batch0", 0.0),
            "host_attention_busy_s": s.host_busy_time, "device_busy_s": s.device_busy_time,
            "iterations": s.iterations, "events": engine.tracer.total if tracing else 0,
            "tokens": {rid: list(r.out_tokens) for rid, r in engine.requests.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true", help="the smoke config (CPU-runnable)")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs import get_config, get_smoke_config

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu for the CPU")
        from repro_torch.kernels import _build

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        _build.build_all()  # outside the timed runs
        name = torch.cuda.get_device_name(0)
    else:
        card = name = "cpu"
    print(card, flush=True)
    cfg = (get_smoke_config if args.smoke else get_config)("qwen3-0.6b")
    runs, want = [], None
    for rnd in range(args.rounds):
        for tracing in (False, True, True, False):
            run = serve_once(cfg, args.device, tracing)
            tokens = run.pop("tokens")
            want = want or tokens
            if tokens != want:
                raise AssertionError(f"round {rnd}, tracing={tracing}: tokens differ")
            print(json.dumps({"run": {"round": rnd, **run}}), flush=True)
            runs.append(run)
            if args.device == "cuda":
                torch.cuda.empty_cache()

    def med(key, traced):
        return statistics.median(r[key] for r in runs if r["traced"] == traced)

    summary = {k: {"untraced": med(k, False), "traced": med(k, True),
                   "ratio": med(k, True) / med(k, False)}
               for k in ("makespan_s", "batch0_s", "host_attention_busy_s", "device_busy_s")}
    events, us = med("events", True), emit_cost_us()
    summary.update(model=cfg.name, rounds=args.rounds, events_per_traced_run=events,
                   emit_us=us, emit_cost_s_per_run=events * us / 1e6, card=card,
                   device=name)
    print(json.dumps({"obs_overhead": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
