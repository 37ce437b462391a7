"""Fig. 9 — relative throughput over synthetic (input × output) length grids
for the three hardware classes, GPU-only as the 1.0 baseline.

Paper claims: peaks of ~+14% (H100-class), ~+26% (A10G), ~7.5× (T4); gains
rise to a balance point then decay toward (or slightly below) 1× as outputs
grow; NEO stays ≈1× when offloading cannot help.

The port's counterpart of the JAX package's ``benchmarks/fig9_lengths.py``, with
its settings and flags, on the port's simulator (``serving/simulator.py``):
it runs on the host, the simulator being a model of the hardware, so
there is no ``--device``.  The JSON lands in ``build/figures/fig9_lengths.json``.
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import print_table, save_json
from repro_torch.configs import get_config
from repro_torch.serving.simulator import simulate
from repro_torch.serving.traces import synthetic_trace

GRIDS = [
    ("T4+LLaMa-2-7B", "t4_g4dn", "llama2-7b", 1,
     [(400, o) for o in (10, 25, 50, 100, 200)]),
    ("A10G+LLaMa-3.1-8B", "a10g_g5_4x", "llama31-8b", 1,
     [(1000, o) for o in (25, 50, 100, 200, 400)]),
    ("2xH100+LLaMa-3.1-70B", "h100_sxm", "llama31-70b", 2,
     [(2000, o) for o in (25, 50, 100, 200, 400)]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    results = {}
    for label, hw, arch, tp, grid in GRIDS:
        cfg = get_config(arch)
        rows = []
        best = 0.0
        if args.quick:
            grid = grid[::2]
        for li, lo in grid:
            # saturating arrival rate so throughput is capacity-bound
            trace = synthetic_trace(args.n, 50.0, li, lo, seed=0)
            base = simulate(cfg, trace, hw=hw, policy="gpu_only", tp=tp).throughput
            m = simulate(cfg, trace, hw=hw, policy="neo", tp=tp)
            rel = m.throughput / max(base, 1e-9)
            best = max(best, rel)
            rows.append([f"{li}x{lo}", round(base, 1), round(m.throughput, 1),
                         round(rel, 3), m.summary()["offload_frac"]])
        print(f"\n=== Fig9: {label} (GPU-only = 1.0) ===")
        print_table(["in x out", "gpu tok/s", "neo tok/s", "neo rel", "offl"], rows)
        print(f"peak gain: {(best - 1) * 100:+.1f}%")
        results[label] = {"rows": rows, "peak_rel": round(best, 3)}
    save_json("fig9_lengths.json", results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
