"""Readings from which a configuration's limits are set, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--control] [--rates 1.5,2.0,2.5] [--out cal.jsonl]

For each seed, in one process: the cell's whole run (set-up, a window of
``--seconds``, the program freed), then the reference over the run's sample
(the lower reading, ``max_logit_gap``) and, with ``--control``, the float8
control over the same sequences (the upper reading).  One JSON line a seed.
The benchmark's own runs never run the control.

``--rates`` is the knee sweep: each rate in place of the mix's, one seed
each in turn, with the first wave scaled by the same factor (Little's law
at the mix's time in the system).  A rate the system sustains ends its
window with few requests still waiting for their first token.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json, or <config>.<traffic> of any two files")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="",
                    help="comma-separated arrival rates in place of the mix's, one a seed (the knee sweep)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.benchmark_spec()
    try:
        cell = harness.cell_of(spec, args.workload)
    except KeyError:
        conf, mix_name = args.workload.split(".", 1)
        cell = {"name": args.workload, "config": conf, "traffic": mix_name, "chips": 1}
    cfg = harness.config_file(cell["config"])
    base = harness.mix_file(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",")] if args.rates else [base["rate"]] * len(seeds)
    dev = torch.device("cuda", 0)
    for seed, rate in zip(seeds, rates):
        mix = dict(base, rate=rate,
                   first_wave=int(round(base["first_wave"] * rate / base["rate"])))
        t0 = time.perf_counter()
        run, extra = harness.run_cell(cell, cfg, mix, seed, args.seconds, False, dev, t0)
        res = harness.check(run, seed, dev, control=args.control)
        values = harness.read_metrics(run, spec["end_to_end"] + spec["per_layer"])
        line = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
                "rate": mix.get("rate"), "attempted": extra["attempted"],
                "first_wave": mix["first_wave"],
                "unfinished_at_close": sum(1 for r in run.recs.values() if r.finished is None),
                "waiting_at_close": sum(1 for r in run.recs.values()
                                        if r.first is None or r.first > run.win.t1),
                "steps_by_rows": harness.step_time_by_rows(run.win.steps),
                "setup_s": run.setup_s, "window_tokens": run.win.tokens,
                "window_s": run.win.seconds, "steps": len(run.win.steps),
                "longest_step_s": max((st.t1 - st.t0 for st in run.win.steps), default=0.0),
                "device_decodes": run.delta("device_decodes"),
                "offloaded_decodes": run.delta("offloaded_decodes"),
                "memory_peak_bytes": extra["memory_peak_bytes"],
                "max_padded_prefill": extra["max_padded_prefill"],
                "metrics": {k: v["value"] for k, v in values.items()}, **res,
                "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
