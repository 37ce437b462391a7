"""Serving launcher of the port.

Runs the port's NeoEngine on the card (``--device cpu`` for the CPU) through
the closed-loop runner :func:`run_trace`: requests are submitted as their
arrival time passes, one engine step per loop turn.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --no-pipeline --trace osc --n 8 --rate 4 --policy neo
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --no-pipeline

Flags are the JAX launcher's.  The dense archs run through the paged engine;
``rwkv6-7b`` (ssm) and ``zamba2-7b`` (hybrid) through the contiguous engine,
for which the pool flags (``--device-pages``, ``--host-pages``) do not apply
and are ignored, as the JAX launcher ignores them, and ``--max-batch-tokens``
is each slot's capacity.  Only the serial engine is ported, so
``--no-pipeline`` is required; the open-loop runner (``--arrivals``,
``--sustained``, ``--slo-ttft``, ``--slo-tpot``), the pipelined engine's
knobs (``--no-microbatch``, ``--max-host-lanes``, ``--no-planahead``), the
prefix cache, tensor parallelism, speculative decoding (``--spec-k``
included) and tracing raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.config import EngineConfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.engine import NeoEngine
from repro_torch.core.request import RequestState
from repro_torch.serving.metrics import RequestRecord, ServeMetrics
from repro_torch.serving.traces import get_trace, save_trace

SLO_TTFT, SLO_TPOT = 10.0, 1.0  # the JAX launcher's defaults (read by --sustained)


def _mirror_stats(engine: NeoEngine, metrics: ServeMetrics) -> None:
    """Copy EngineStats counters into a ServeMetrics."""
    s = engine.stats
    metrics.iterations = s.iterations
    metrics.mode_counts = dict(s.mode_counts)
    metrics.offloaded_decodes = s.offloaded_decodes
    metrics.device_decodes = s.device_decodes
    metrics.host_busy_time = s.host_busy_time
    metrics.device_busy_time = s.device_busy_time
    metrics.lane_busy = dict(s.lane_busy_time)
    metrics.prefill_tokens_computed = s.prefill_tokens
    metrics.plan_busy_time = s.plan_busy_time
    metrics.rejected_requests = s.rejected_requests
    if engine.pool is not None:
        metrics.swap_bytes = engine.pool.swap_bytes


def run_trace(engine: NeoEngine, trace, *, vocab: int, seed: int = 0,
              max_iters: int = 100_000) -> ServeMetrics:
    """Feed a trace into a real engine, respecting arrival times (virtual
    clock advanced by wall-time of each iteration)."""
    rng = np.random.default_rng(seed)
    pending = sorted(trace, key=lambda t: t.arrival_time)
    for t in pending:
        t.materialise(rng, vocab)
    metrics = ServeMetrics()
    records = {}
    i = 0
    iters = 0
    t0 = time.perf_counter()
    while iters < max_iters:
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].arrival_time <= now:
            tr = pending[i]
            rid = engine.submit(tr.prompt, tr.output_len, arrival_time=tr.arrival_time)
            records[rid] = RequestRecord(rid, tr.arrival_time, tr.prompt_len, tr.output_len)
            metrics.records.append(records[rid])
            i += 1
        emitted = engine.step(now=now)
        iters += 1
        done_now = time.perf_counter() - t0
        for rid, req in engine.requests.items():
            rec = records.get(rid)
            if rec is None:
                continue
            if req.first_token_time is not None and rec.first_token_time is None:
                rec.first_token_time = done_now
            if req.finish_time is not None and rec.finish_time is None:
                rec.finish_time = done_now
                rec.status = ("cancelled"
                              if req.state == RequestState.ABORTED
                              else "finished")
        if not emitted and i >= len(pending) and engine.scheduler.num_queued == 0:
            break
        if not emitted and i < len(pending):
            time.sleep(max(0.0, pending[i].arrival_time - (time.perf_counter() - t0)))
    metrics.makespan = time.perf_counter() - t0
    _mirror_stats(engine, metrics)
    return metrics


def _clamp_trace(trace, max_batch_tokens: int, max_output: int = 32):
    """Clamp lengths to smoke scale, as the JAX launcher does."""
    for t in trace:
        t.prompt_len = min(t.prompt_len, max_batch_tokens // 4)
        if t.prompt is not None:
            t.prompt = t.prompt[: t.prompt_len]
        t.output_len = min(t.output_len, max_output)
    return trace


def _unported_flags(args) -> str:
    """The first flag asking for something the port does not run yet."""
    if not args.no_pipeline:
        return ("pipelined execution is not ported yet (ROADMAP P7); "
                "pass --no-pipeline")
    if (args.no_microbatch or args.no_planahead
            or args.max_host_lanes != EngineConfig.max_host_lanes):
        return ("micro-batching, host lanes and plan-ahead belong to the pipelined "
                "engine, not ported yet (ROADMAP P7)")
    if (args.arrivals != "closed" or args.sustained
            or (args.slo_ttft, args.slo_tpot) != (SLO_TTFT, SLO_TPOT)):
        return "open-loop serving (run_online, run_sustained) is not ported yet (ROADMAP P6/P7)"
    if args.prefix_cache or args.require_hits or args.host_serving:
        return "the prefix cache is not ported yet (ROADMAP P9)"
    if args.tp != 1:
        return "tensor-parallel serving is not ported yet (ROADMAP P13)"
    if (args.spec_decode or args.draft_model or args.require_accepts
            or args.spec_k != EngineConfig.spec_k):
        return "speculative decoding is not ported yet (ROADMAP P10)"
    if args.trace_out or args.counters_out or args.require_reconcile:
        return "engine tracing is not ported yet (ROADMAP P8)"
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (the card by default)")
    ap.add_argument("--policy", default="neo",
                    choices=["neo", "gpu_only", "fastdecode", "simple"])
    ap.add_argument("--trace", default="osc")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--device-pages", type=int, default=64)
    ap.add_argument("--host-pages", type=int, default=256)
    ap.add_argument("--max-batch-tokens", type=int, default=2048)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial execution (required: the pipelined engine is not ported yet)")
    ap.add_argument("--no-microbatch", action="store_true")
    ap.add_argument("--max-host-lanes", type=int, default=EngineConfig.max_host_lanes)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--require-hits", action="store_true")
    ap.add_argument("--host-serving", action="store_true")
    ap.add_argument("--arrivals", default="closed")
    ap.add_argument("--no-planahead", action="store_true")
    ap.add_argument("--max-waiting", type=int, default=0)
    ap.add_argument("--slo-ttft", type=float, default=SLO_TTFT)
    ap.add_argument("--slo-tpot", type=float, default=SLO_TPOT)
    ap.add_argument("--sustained", action="store_true")
    ap.add_argument("--save-trace", default="",
                    help="write the (clamped) trace as JSONL for replay")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--counters-out", default="")
    ap.add_argument("--require-reconcile", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--spec-decode", action="store_true")
    ap.add_argument("--spec-k", type=int, default=EngineConfig.spec_k)
    ap.add_argument("--draft-model", default="")
    ap.add_argument("--require-accepts", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    why = _unported_flags(args)
    if why:
        raise NotImplementedError(why)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ecfg = EngineConfig(
        device_pool_pages=args.device_pages,
        host_pool_pages=args.host_pages,
        max_batch_tokens=args.max_batch_tokens,
        policy=args.policy,
        pipeline=False,
        max_waiting=args.max_waiting,
        seed=args.seed,
    )
    print(f"[serve] arch={cfg.name} policy={args.policy} device={args.device} "
          f"pipeline=False pools=({args.device_pages},{args.host_pages})")
    engine = NeoEngine(cfg, ecfg, device=args.device)
    trace = get_trace(args.trace, args.n, args.rate, args.seed)
    _clamp_trace(trace, args.max_batch_tokens)
    if args.save_trace:
        save_trace(trace, args.save_trace)
        print(f"[serve] wrote {len(trace)} requests to {args.save_trace}")
    m = run_trace(engine, trace, vocab=cfg.vocab_size, seed=args.seed)
    engine.close()
    print(json.dumps(m.summary(), indent=1))
    print("scheduler modes:", m.mode_counts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
