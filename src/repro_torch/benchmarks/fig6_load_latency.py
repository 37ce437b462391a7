"""Fig. 6 — load–latency curves, NEO vs GPU-only, three hardware classes.

Also Fig. 7 (``--dist``): the per-token latency distribution at a fixed rate
in the A10G setting.

Paper claims validated here: NEO sustains higher load at equal latency —
+14.3% on H100-class, +6.4% on A10G (at 2 s), ~5.6× on T4 (at 1 s).

The port's counterpart of the JAX package's ``benchmarks/fig6_load_latency.py``, with
its settings and flags, on the port's simulator (``serving/simulator.py``):
it runs on the host, the simulator being a model of the hardware, so
there is no ``--device``.  The JSON lands in ``build/figures/fig6_load_latency.json``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import FIG6_SETTINGS, print_table, save_json
from repro_torch.configs import get_config
from repro_torch.serving.simulator import simulate
from repro_torch.serving.traces import get_trace


def sustained_rate(curve, latency_budget_s: float) -> float:
    """Largest request rate whose mean per-token latency fits the budget."""
    best = 0.0
    for rate, m in curve:
        if m.per_token_latency() <= latency_budget_s:
            best = max(best, rate)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=150, help="requests per point")
    ap.add_argument("--dist", action="store_true", help="Fig. 7 distribution")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    results = {}
    for label, hw, arch, trace_name, tp, rates in FIG6_SETTINGS:
        cfg = get_config(arch)
        if args.quick:
            rates = rates[::2]
        rows = []
        curves = {"neo": [], "gpu_only": []}
        for rate in rates:
            trace = get_trace(trace_name, args.n, rate, seed=0)
            row = [rate]
            for pol in ("neo", "gpu_only"):
                m = simulate(cfg, trace, hw=hw, policy=pol, tp=tp)
                curves[pol].append((rate, m))
                row += [round(m.per_token_latency() * 1e3, 1),
                        round(m.throughput, 1),
                        m.summary()["offload_frac"]]
            rows.append(row)
        print(f"\n=== Fig6: {label} ===")
        print_table(
            ["rate", "neo ptl ms", "neo tok/s", "neo offl",
             "gpu ptl ms", "gpu tok/s", "gpu offl"], rows)
        budget = 1.0 if "T4" in label else 2.0
        r_neo = sustained_rate(curves["neo"], budget)
        r_gpu = sustained_rate(curves["gpu_only"], budget)
        gain = (r_neo / r_gpu - 1) * 100 if r_gpu else float("inf")
        print(f"sustained load at {budget:.0f}s per-token budget: "
              f"NEO {r_neo}/s vs GPU-only {r_gpu}/s -> +{gain:.1f}%")
        results[label] = {
            "rows": rows, "budget_s": budget,
            "neo_rate": r_neo, "gpu_rate": r_gpu, "gain_pct": round(gain, 1),
        }

    if args.dist:
        label, hw, arch, trace_name, tp, _ = FIG6_SETTINGS[1]
        cfg = get_config(arch)
        trace = get_trace(trace_name, args.n, 1.6, seed=0)
        print(f"\n=== Fig7: latency distribution ({label} @1.6/s) ===")
        rows = []
        for pol in ("neo", "gpu_only"):
            m = simulate(cfg, trace, hw=hw, policy=pol, tp=tp)
            d = m.latency_distribution() * 1e3
            pct = {p: round(float(np.percentile(d, p)), 1) for p in (50, 75, 90, 95, 99)}
            rows.append([pol] + list(pct.values()))
            results[f"fig7_{pol}"] = pct
        print_table(["policy", "p50 ms", "p75", "p90", "p95", "p99"], rows)

    save_json("fig6_load_latency.json", results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
