"""Capacity planner: given a hardware class + model + workload shape, sweep
NEO vs GPU-only through the calibrated simulator and report the sustainable
load and the offload equilibrium — the tool an operator would use before
enabling NEO on a fleet (the JAX package's ``examples/capacity_planner.py``
on the port's simulator).

    PYTHONPATH=src python -m repro_torch.examples.capacity_planner \\
        --hw t4_g4dn --arch llama2-7b --input 400 --output 50 [--device cpu]

The simulator itself runs on the host; ``--device`` keeps the port's rule
for its entry points (the card unless ``cpu`` is asked for, and an error
without one), so a run never passes for one made beside a card.
"""

from __future__ import annotations

import argparse

import repro_torch.configs.paper_models  # noqa: F401  (registers the llama models)
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.roofline.hw import HARDWARE, get_profile
from repro_torch.serving.simulator import simulate, size_pools
from repro_torch.serving.traces import synthetic_trace


def main(argv=None) -> dict:
    """Print the sweep; return the sustainable rates by policy."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.capacity_planner")
    ap.add_argument("--hw", default="t4_g4dn", choices=sorted(HARDWARE))
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--input", type=int, default=400)
    ap.add_argument("--output", type=int, default=50)
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--latency-budget", type=float, default=1.0,
                    help="mean per-token latency budget (s)")
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = get_config(args.arch)
    hw = get_profile(args.hw)
    dp, hp = size_pools(cfg, hw)
    print(f"{args.arch} on {args.hw}: device pool {dp} pages "
          f"({dp * cfg.kv_block_size} tokens), host pool {hp} pages")
    print(f"workload: input≈{args.input}, output≈{args.output}, "
          f"budget {args.latency_budget}s/token\n")

    print(f"{'rate':>6} | {'gpu ptl':>9} {'gpu tok/s':>9} | "
          f"{'neo ptl':>9} {'neo tok/s':>9} {'offl':>5}")
    best = {"gpu_only": 0.0, "neo": 0.0}
    rate = 0.25
    while rate <= 64:
        trace = synthetic_trace(args.n, rate, args.input, args.output, seed=0)
        row = f"{rate:6.2f} |"
        over_budget = True
        for pol in ("gpu_only", "neo"):
            m = simulate(cfg, trace, hw=args.hw, policy=pol)
            ptl = m.per_token_latency()
            if ptl <= args.latency_budget:
                best[pol] = max(best[pol], rate)
                over_budget = False
            if pol == "gpu_only":
                row += f" {ptl * 1e3:8.0f}ms {m.throughput:9.1f} |"
            else:
                row += (f" {ptl * 1e3:8.0f}ms {m.throughput:9.1f} "
                        f"{m.summary()['offload_frac']:5.2f}")
        print(row)
        if over_budget:
            break
        rate *= 2

    gain = (best["neo"] / best["gpu_only"] - 1) * 100 if best["gpu_only"] else float("inf")
    print(f"\nsustainable load at {args.latency_budget}s/token: "
          f"GPU-only {best['gpu_only']}/s, NEO {best['neo']}/s  ->  {gain:+.0f}%")
    return best


if __name__ == "__main__":
    main()
