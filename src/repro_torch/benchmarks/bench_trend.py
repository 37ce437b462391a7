"""Bench-trend gate of the port (the counterpart of the JAX package's
``benchmarks/bench_trend.py``): run the engine, prefix-cache, sharded and
sustained-load sections, write the schema'd summary to
``build/BENCH_engine.json``, and fail on a regression against a baseline.

The schema (``neo-bench-trend/v6``), its fields and the gates are the
reference's (``benchmarks/README.md``): ``engine.bubble_fraction`` within
``BUBBLE_TOL`` of the baseline, micro-batched and borrowed-lane steps > 0,
``prefix_cache.hit_rate`` within ``HIT_RATE_TOL``, host-served hit tokens
and in-place host hits > 0, plan-ahead hits > 0 and bitwise outputs in the
sustained A/B, the sharded gates, the speculation gates, tracing overhead
at most ``TRACING_OVERHEAD_TOL`` and ``reconcile`` ok.  Throughputs and
latencies are recorded, not gated.

Two baselines sit beside this module: ``BENCH_baseline.json``, a copy of
the reference's smoke baseline (the default with ``--smoke``), and
``BENCH_baseline_h100.json``, written on one H100 at full width (the
default otherwise; its ``card`` field names the card and power limit).

Two bitwise claims follow where a host row's attention ran (ROADMAP
queue 3): prefix cache on = off and the sustained loops' outputs.  With
``bitwise_dtype`` (``--bitwise-dtype``) other than the model's, their
sections run again in it (at ``--recheck-layers`` layers when given: full
width, cut depth) and those verdicts replace the model dtype's.
Speculation on = off stays in the model's dtype: the spec section's
fastdecode burst keeps every row and pseudo-row on the host, so no row
changes residency.  ``bitwise_record`` keeps the three claims' token
matches in the model's dtype.

The spec section takes its own perf-model and host-thread settings
(``--spec-ewma-alpha``, ``--spec-host-threads``): by default the
reference's, the perf model live and one host attention thread, whatever
``--ewma-alpha`` sets for the other sections.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_trend --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_trend --bitwise-dtype float32
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional

from repro_torch.benchmarks.common import (BUILD_DIR, HERE, add_engine_args, bench_config,
                                           card_line, engine_opts, free_params)

SCHEMA = "neo-bench-trend/v6"
BASELINE_PATH = os.path.join(HERE, "BENCH_baseline.json")
H100_BASELINE_PATH = os.path.join(HERE, "BENCH_baseline_h100.json")
SUMMARY_PATH = os.path.join(BUILD_DIR, "BENCH_engine.json")

# Gate tolerances: bubble_fraction is a structural ratio (stable across
# machines), throughputs are not: only ratios and counters are gated.
BUBBLE_TOL = 0.05
HIT_RATE_TOL = 0.05
TRACING_OVERHEAD_TOL = 0.05
# the bitwise claims re-run in ``bitwise_dtype``: their outcome follows
# where a host row's attention ran
RECHECK = ("prefix_cache", "sustained")


def tokens_equal(a: dict, b: dict):
    """[equal tokens, tokens] of two runs' outputs by request."""
    same = sum(x == y for k in a for x, y in zip(a[k], b.get(k, [])))
    return [same, sum(len(v) for v in a.values())]


def _prefix_ok(pc: dict) -> bool:
    """The prefix-cache section's gates other than the two bitwise ones."""
    on = pc["hs_cache_on"]
    return (pc["prefill_reduction"] >= 2.0 and on["inplace_host_hits"] > 0
            and on["host_hit_pcie_bytes"] <= 0 and on["promoted"] <= 0
            and pc["hs_token_granular_extra_hit_tokens"] > 0)


def collect(n: int, *, bitwise_dtype: Optional[str] = None,
            recheck_layers: Optional[int] = None, prefix_n: int = 8,
            spec_ewma_alpha: Optional[float] = None, spec_host_threads: int = 1,
            fastdecode: Optional[tuple] = None, raw: Optional[dict] = None, log=print,
            section=None, **opts) -> tuple:
    """Run the sections and collate their results into the trend summary.
    ``opts`` are the engine benchmarks' options (arch, smoke, dtype, device,
    seed, params, ewma_alpha), full width unless ``smoke`` is given, for
    every section but the spec section's perf model and host threads,
    which are ``spec_ewma_alpha`` (None: live) and ``spec_host_threads``;
    ``prefix_n`` is the prefix section's turns (``--quick``'s 8);
    ``bitwise_dtype`` and ``recheck_layers``: see the module docstring;
    ``fastdecode``, when given, is an untraced micro-batched fastdecode
    burst of ``n`` already run with ``opts`` (result, outputs), as
    ``engine_real.main`` shares its policy table's; ``raw``, when given,
    receives each section's results, verdict and wall time;
    ``section(name)``, when given, is a context manager entered around each
    section's run.  Returns (rc, summary)."""
    from repro_torch.benchmarks import engine_real, engine_sharded, prefix_cache
    from repro_torch.benchmarks.engine_real import merge_save
    from repro_torch.benchmarks.common import save_json
    from repro_torch.launch.serve import run_sustained

    raw = {} if raw is None else raw
    # run_sustained defaults to the smoke model: every section gets it named
    opts = dict(opts, smoke=opts.get("smoke", False))
    cfg = bench_config(opts.get("arch", "qwen3-0.6b"), smoke=opts["smoke"],
                       dtype=opts.get("dtype"), layers=opts.get("layers"))
    recheck = bitwise_dtype is not None and bitwise_dtype != cfg.activation_dtype
    walls = raw.setdefault("wall_s", {})

    def timed(name, fn):
        t0 = time.perf_counter()
        with (section(name) if section is not None else contextlib.nullcontext()):
            out = fn()
        walls[name] = round(time.perf_counter() - t0, 2)
        log(f"[bench_trend] {name}: {walls[name]} s")
        return out

    outs = {"spec": {}, "prefix": {}, "sustained": {}}
    # the fastdecode burst with micro-batching on, untraced, is both the
    # micro-batch section's "on" run and the tracing section's "off" run (as
    # engine_real.main shares it)
    fd = fastdecode
    if fd is None:
        fd = timed("fastdecode", lambda: engine_real.run("fastdecode", n, **opts))
    rc_mb, mb = timed("microbatch", lambda: engine_real.run_microbatch_section(
        n, on=fd, **opts))
    rc_ml, ml = timed("mixed_lane", lambda: engine_real.run_mixed_lane_section(**opts))
    rc_obs, obs = timed("obs", lambda: engine_real.run_obs_section(n, off=fd, **opts))
    rc_sp, sp = timed("spec", lambda: engine_real.run_spec_section(
        n, outputs=outs["spec"], **dict(opts, ewma_alpha=spec_ewma_alpha,
                                        host_threads=spec_host_threads)))
    merge_save({**mb, **ml, **obs, **sp})
    rc_pc, pc = timed("prefix_cache", lambda: prefix_cache.run_section(
        prefix_n, host_serving=True, outputs=outs["prefix"], **opts))
    save_json("prefix_cache.json", pc)
    sh = timed("sharded", lambda: engine_sharded.run(**opts))
    sh.pop("outputs")
    save_json("engine_sharded.json", sh)
    rc_sh = engine_sharded.check(sh)
    sus = timed("sustained", lambda: run_sustained(
        n=max(n, 12), rate=8.0, outputs=outs["sustained"], **opts))
    free_params()
    raw.update(engine_real={**mb, **ml, **obs, **sp}, prefix_cache=pc, sharded=sh,
               sustained=sus)

    # the bitwise claims that follow where a host row attended: each match
    # in the model's dtype recorded; RECHECK's sections run again in
    # bitwise_dtype, whose verdicts replace the model dtype's
    record = {
        "model_dtype": cfg.activation_dtype,
        "spec_ngram_vs_off": tokens_equal(outs["spec"]["off"], outs["spec"]["ngram"]),
        "spec_oracle_vs_off": tokens_equal(outs["spec"]["off"], outs["spec"]["oracle"]),
        "prefix_cache_on_vs_off": tokens_equal(outs["prefix"]["cache_off"],
                                               outs["prefix"]["cache_on"]),
        "prefix_host_serving_on_vs_off": tokens_equal(outs["prefix"]["hs_cache_off"],
                                                      outs["prefix"]["hs_cache_on"]),
        "sustained_open_vs_closed": tokens_equal(outs["sustained"]["closed"],
                                                 outs["sustained"]["open"]),
        "model_dtype_verdicts": {
            "prefix_outputs_identical": pc["outputs_identical"],
            "prefix_hs_outputs_identical": pc["hs_outputs_identical"],
            "sustained_bitwise_identical": sus["gates"]["bitwise_identical"]},
        "asserted_in": cfg.activation_dtype,
    }
    if recheck:
        chk = dict(opts, dtype=bitwise_dtype)
        if recheck_layers is not None:
            chk["layers"] = recheck_layers
        _, pc2 = timed(f"prefix_cache_{bitwise_dtype}", lambda: prefix_cache.run_section(
            prefix_n, host_serving=True, page_aligned=False, **chk))
        sus2 = timed(f"sustained_{bitwise_dtype}", lambda: run_sustained(
            n=max(n, 12), rate=8.0, **chk))
        free_params()
        raw.update(prefix_cache_check=pc2, sustained_check=sus2)
        pc = dict(pc, outputs_identical=pc2["outputs_identical"],
                  hs_outputs_identical=pc2["hs_outputs_identical"])
        sus = dict(sus, gates=dict(sus["gates"],
                                   bitwise_identical=sus2["gates"]["bitwise_identical"]))
        rc_pc = int(not (_prefix_ok(pc) and pc["outputs_identical"]
                         and pc["hs_outputs_identical"]))
        record.update(asserted_in=bitwise_dtype, recheck_layers=recheck_layers)
        for name, ok in record["model_dtype_verdicts"].items():
            log(f"[bench_trend] {name} in {cfg.activation_dtype}: {ok} (record; asserted "
                f"in {bitwise_dtype})")
    rc = rc_mb | rc_ml | rc_obs | rc_sp | rc_pc | rc_sh
    raw["rc"] = dict(microbatch=rc_mb, mixed_lane=rc_ml, obs=rc_obs, spec=rc_sp,
                     prefix_cache=rc_pc, sharded=rc_sh)

    er = {**mb, **ml, **obs, **sp}
    mb_on = er["fastdecode_mb_on"]
    mb_off = er["fastdecode_mb_off"]
    mixed = er["mixed_pipelined"]
    smoke = opts["smoke"]
    summary = {
        "schema": SCHEMA,
        "arch": (f"{cfg.name.removesuffix('-smoke')} (smoke)" if smoke
                 else f"{cfg.name} (full width, {cfg.activation_dtype})"),
        "engine": {
            "fastdecode_mb_on_tok_s": mb_on["token_throughput"],
            "fastdecode_mb_off_tok_s": mb_off["token_throughput"],
            "mixed_pipelined_tok_s": mixed["token_throughput"],
            "bubble_fraction": mb_on["bubble_fraction"],
            "bubble_fraction_serialized": mb_off["bubble_fraction"],
            "microbatched_steps": mb_on["microbatched_steps"],
            "borrowed_lane_steps": mixed["borrowed_lane_steps"],
            "lane_count_steps": mixed["lane_count_steps"],
        },
        "prefix_cache": {
            "hit_rate": pc["cache_on"]["hit_rate"],
            "prefill_reduction": pc["prefill_reduction"],
            "cache_on_tok_s": pc["cache_on"]["token_throughput"],
            # zero-copy host-tier serving (--host-serving section)
            "host_served_hit_tokens": pc["hs_cache_on"]["host_served_hit_tokens"],
            "inplace_host_hits": pc["hs_cache_on"]["inplace_host_hits"],
            "token_granular_extra_hit_tokens":
                pc["hs_token_granular_extra_hit_tokens"],
        },
        "serving": {
            "closed_goodput_rps": sus["closed"]["goodput_rps"],
            "open_goodput_rps": sus["open"]["goodput_rps"],
            "closed_ttft_p99_ms": sus["closed"]["ttft_p99_ms"],
            "open_ttft_p99_ms": sus["open"]["ttft_p99_ms"],
            "closed_tpot_p99_ms": sus["closed"]["tpot_p99_ms"],
            "open_tpot_p99_ms": sus["open"]["tpot_p99_ms"],
            "planahead_hits": sus["open"]["planahead_hits"],
            "planahead_replans": sus["open"]["planahead_replans"],
            "planahead_hidden_s": sus["open"]["planahead_hidden_s"],
            "bitwise_identical": sus["gates"]["bitwise_identical"],
        },
        "obs": {
            "tracing_off_tok_s": er["obs_tracing_off"]["token_throughput"],
            "tracing_on_tok_s": er["obs_tracing_on"]["token_throughput"],
            "tracing_overhead": er["obs_tracing_on"]["tracing_overhead"],
            "reconcile_ok": er["obs_tracing_on"]["reconcile_ok"],
            "trace_events": er["obs_tracing_on"]["trace_events"],
            "trace_dropped": er["obs_tracing_on"]["trace_dropped"],
        },
        "spec": {
            "bitwise_ok": er["spec_gates"]["bitwise_ok"],
            "oracle_speedup": er["spec_gates"]["oracle_speedup"],
            "oracle_accepted": er["spec_oracle"]["accepted_tokens"],
            "oracle_accept_len_hist": er["spec_oracle"]["accept_len_hist"],
            "ngram_drafted": er["spec_ngram"]["drafted_tokens"],
            "ngram_accepted": er["spec_ngram"]["accepted_tokens"],
            "spec_off_tok_s": er["spec_off"]["token_throughput"],
            "spec_ngram_tok_s": er["spec_ngram"]["token_throughput"],
            "spec_oracle_tok_s": er["spec_oracle"]["token_throughput"],
        },
        "sharded": {
            "tp2_bitwise_ok": sh["tp2_bitwise_ok"],
            "swap_bytes_equal": sh["swap_bytes_equal"],
            "stream_split_exact": sh["stream_split_exact"],
            "bytes_out": sh["bytes_out"],
            "bytes_in": sh["bytes_in"],
            "tp2_copy_streams": sh["tp2_copy_streams"],
            "tp1_tok_s": sh["tp1_tok_s"],
            "tp2_tok_s": sh["tp2_tok_s"],
        },
    }
    summary["bitwise_record"] = record
    dev = opts.get("device")
    if dev is None or str(dev).startswith("cuda"):
        summary["card"] = card_line()
    return rc, summary


def gate(summary: dict, baseline: dict) -> int:
    """Compare the fresh summary against the baseline; returns the number
    of regressions (0 == green)."""
    fails = 0
    b_eng, s_eng = baseline["engine"], summary["engine"]
    if s_eng["bubble_fraction"] > b_eng["bubble_fraction"] + BUBBLE_TOL:
        print(f"[bench_trend] FAIL: bubble_fraction regressed "
              f"{b_eng['bubble_fraction']} -> {s_eng['bubble_fraction']} "
              f"(tol {BUBBLE_TOL})")
        fails += 1
    if s_eng["microbatched_steps"] == 0:
        print("[bench_trend] FAIL: no micro-batched steps in the fastdecode "
              "smoke")
        fails += 1
    if s_eng["borrowed_lane_steps"] == 0:
        print("[bench_trend] FAIL: no borrowed-lane steps in the mixed-plan "
              "smoke")
        fails += 1
    b_pc, s_pc = baseline["prefix_cache"], summary["prefix_cache"]
    if s_pc["hit_rate"] < b_pc["hit_rate"] - HIT_RATE_TOL:
        print(f"[bench_trend] FAIL: prefix-cache hit_rate regressed "
              f"{b_pc['hit_rate']} -> {s_pc['hit_rate']} (tol {HIT_RATE_TOL})")
        fails += 1
    if s_pc.get("host_served_hit_tokens", 0) <= 0:
        print("[bench_trend] FAIL: no host-served hit tokens in the "
              "host-serving smoke")
        fails += 1
    if s_pc.get("inplace_host_hits", 0) <= 0:
        print("[bench_trend] FAIL: no in-place host hits in the "
              "host-serving smoke")
        fails += 1
    s_srv = summary.get("serving", {})
    if s_srv.get("planahead_hits", 0) <= 0:
        print("[bench_trend] FAIL: plan-ahead never adopted a speculative "
              "plan in the sustained-load smoke")
        fails += 1
    if not s_srv.get("bitwise_identical", False):
        print("[bench_trend] FAIL: plan-ahead changed greedy outputs in the "
              "sustained-load smoke")
        fails += 1
    s_sh = summary.get("sharded", {})
    if not s_sh.get("tp2_bitwise_ok", False):
        print("[bench_trend] FAIL: TP=2 greedy outputs diverge from TP=1 "
              "in the sharded smoke")
        fails += 1
    if not s_sh.get("swap_bytes_equal", False):
        print("[bench_trend] FAIL: TP=2 swap byte totals differ from TP=1 "
              "in the sharded smoke")
        fails += 1
    if not s_sh.get("stream_split_exact", False):
        print("[bench_trend] FAIL: per-shard copy-stream bytes do not "
              "partition the totals in the sharded smoke")
        fails += 1
    s_sp = summary.get("spec", {})
    if not s_sp.get("bitwise_ok", False):
        print("[bench_trend] FAIL: speculative decoding changed greedy "
              "outputs in the spec smoke")
        fails += 1
    if s_sp.get("oracle_accepted", 0) <= 0:
        print("[bench_trend] FAIL: the verify pass accepted 0 drafted "
              "tokens in the spec smoke")
        fails += 1
    hist = s_sp.get("oracle_accept_len_hist", {})
    if not any(int(k) >= 1 and v > 0 for k, v in hist.items()):
        print("[bench_trend] FAIL: accepted-length histogram empty at >= 1 "
              "in the spec smoke")
        fails += 1
    if s_sp.get("oracle_speedup", 0.0) <= 1.0:
        print(f"[bench_trend] FAIL: no speculative throughput win "
              f"(oracle_speedup={s_sp.get('oracle_speedup')})")
        fails += 1
    s_obs = summary.get("obs", {})
    if s_obs.get("tracing_overhead", 0.0) > TRACING_OVERHEAD_TOL:
        print(f"[bench_trend] FAIL: tracing overhead "
              f"{s_obs['tracing_overhead']:.2%} exceeds "
              f"{TRACING_OVERHEAD_TOL:.0%} of untraced tok/s")
        fails += 1
    if not s_obs.get("reconcile_ok", False):
        print("[bench_trend] FAIL: span timeline disagrees with EngineStats "
              "(reconcile) in the tracing smoke")
        fails += 1
    if not fails:
        print(f"[bench_trend] OK: bubble {s_eng['bubble_fraction']} "
              f"(baseline {b_eng['bubble_fraction']}), hit_rate "
              f"{s_pc['hit_rate']} (baseline {b_pc['hit_rate']})")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12,
                    help="requests per engine smoke run")
    ap.add_argument("--write-baseline", action="store_true",
                    help="refresh the baseline instead of gating against it")
    ap.add_argument("--baseline", default=None,
                    help="default: BENCH_baseline.json with --smoke, else "
                         "BENCH_baseline_h100.json")
    ap.add_argument("--bitwise-dtype", default=None, choices=("float32", "bfloat16"),
                    help="assert the host-row bitwise claims (" + ", ".join(RECHECK)
                         + ") in this dtype")
    ap.add_argument("--recheck-layers", type=int, default=None,
                    help="depth of the --bitwise-dtype re-runs (default: the model's)")
    ap.add_argument("--prefix-n", type=int, default=8,
                    help="turns of the prefix-cache section (prefix_cache --quick: 8)")
    ap.add_argument("--spec-ewma-alpha", type=float, default=None,
                    help="the spec section's perf-model EWMA weight (default: the "
                         "config's, live, as the reference runs it)")
    ap.add_argument("--spec-host-threads", type=int, default=1,
                    help="the spec section's host attention threads (the reference's: 1)")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    baseline_path = args.baseline or (BASELINE_PATH if args.smoke else H100_BASELINE_PATH)

    rc, summary = collect(args.n, bitwise_dtype=args.bitwise_dtype,
                          recheck_layers=args.recheck_layers, prefix_n=args.prefix_n,
                          spec_ewma_alpha=args.spec_ewma_alpha,
                          spec_host_threads=args.spec_host_threads, **engine_opts(args))
    os.makedirs(os.path.dirname(SUMMARY_PATH), exist_ok=True)
    with open(SUMMARY_PATH, "w") as f:
        json.dump(summary, f, indent=1)
        f.write("\n")
    print(f"[bench_trend] wrote {SUMMARY_PATH}")
    if rc:
        print("[bench_trend] FAIL: a smoke gate failed (see above)")
        return rc
    if args.write_baseline:
        with open(baseline_path, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
        print(f"[bench_trend] baseline refreshed: {baseline_path}")
        return 0
    if not os.path.exists(baseline_path):
        print(f"[bench_trend] FAIL: no baseline at {baseline_path} "
              f"(run with --write-baseline and commit it)")
        return 1
    with open(baseline_path) as f:
        baseline = json.load(f)
    return 1 if gate(summary, baseline) else 0


if __name__ == "__main__":
    sys.exit(main())
