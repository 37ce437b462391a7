"""Fig. 10a — host-capacity sensitivity: the g5 instance family
(g5.2x/4x/8x/16xlarge; same A10G GPU, 2×-stepped host memory bandwidth).

Paper claim: peak gain is positively related to host memory bandwidth —
+12.2% / +13.3% / +29.7% / +79.3% — i.e. bandwidth (not core count) is what
the offloaded attention scales with (§5.5).

The port's counterpart of the JAX package's ``benchmarks/fig10a_cpu.py``, with
its settings and flags, on the port's simulator (``serving/simulator.py``):
it runs on the host, the simulator being a model of the hardware, so
there is no ``--device``.  The JSON lands in ``build/figures/fig10a_cpu.json``.
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import print_table, save_json
from repro_torch.configs import get_config
from repro_torch.serving.simulator import simulate
from repro_torch.serving.traces import synthetic_trace

INSTANCES = ["a10g_g5_2x", "a10g_g5_4x", "a10g_g5_8x", "a10g_g5_16x"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("llama31-8b")
    out_lens = (50, 200) if args.quick else (25, 50, 100, 200, 400)
    rows = []
    results = {}
    for hw in INSTANCES:
        peak = 0.0
        per_len = []
        for lo in out_lens:
            trace = synthetic_trace(args.n, 50.0, 1000, lo, seed=0)
            base = simulate(cfg, trace, hw=hw, policy="gpu_only").throughput
            thr = simulate(cfg, trace, hw=hw, policy="neo").throughput
            rel = thr / max(base, 1e-9)
            peak = max(peak, rel)
            per_len.append(round(rel, 3))
        rows.append([hw] + per_len + [f"{(peak - 1) * 100:+.1f}%"])
        results[hw] = {"rel_by_output_len": per_len, "peak_gain_pct": round((peak - 1) * 100, 1)}
    print("=== Fig10a: host-bandwidth sensitivity (A10G + LLaMa-3.1-8B) ===")
    print_table(["instance"] + [f"out={o}" for o in out_lens] + ["peak gain"], rows)
    save_json("fig10a_cpu.json", results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
