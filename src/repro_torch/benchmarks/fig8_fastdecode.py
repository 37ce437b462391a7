"""Fig. 8 — NEO vs FastDecode+ (full offload) vs GPU-only baseline.

(a) latency on the AC trace in the 2×H100 + 70B setting;
(b) relative throughput with input fixed at 2000 and output length swept —
    the paper shows FastDecode+ collapsing below baseline at long outputs
    while NEO never drops below 1× (its scheduler falls back to GPU-only).

The port's counterpart of the JAX package's ``benchmarks/fig8_fastdecode.py``, with
its settings and flags, on the port's simulator (``serving/simulator.py``):
it runs on the host, the simulator being a model of the hardware, so
there is no ``--device``.  The JSON lands in ``build/figures/fig8_fastdecode.json``.
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import print_table, save_json
from repro_torch.configs import get_config
from repro_torch.serving.simulator import simulate
from repro_torch.serving.traces import get_trace, synthetic_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("llama31-70b")
    hw, tp = "h100_sxm", 2
    results = {}

    # (a) latency under load
    print("=== Fig8a: 2xH100+70B, AC trace, latency ===")
    rows = []
    rates = (1.0, 2.0) if args.quick else (0.5, 1.0, 1.5, 2.0, 2.5)
    for rate in rates:
        trace = get_trace("ac", args.n, rate, seed=0)
        row = [rate]
        for pol in ("neo", "fastdecode", "gpu_only"):
            m = simulate(cfg, trace, hw=hw, policy=pol, tp=tp)
            row.append(round(m.per_token_latency() * 1e3, 1))
        rows.append(row)
    print_table(["rate", "neo ptl ms", "fastdecode ptl ms", "gpu_only ptl ms"], rows)
    results["fig8a"] = rows

    # (b) relative throughput vs output length (input fixed at 2000)
    print("\n=== Fig8b: throughput relative to GPU-only, input=2000 ===")
    rows = []
    out_lens = (50, 200, 800) if args.quick else (25, 50, 100, 200, 400, 800)
    for out_len in out_lens:
        trace = synthetic_trace(args.n, 10.0, 2000, out_len, seed=0)
        base = simulate(cfg, trace, hw=hw, policy="gpu_only", tp=tp).throughput
        row = [out_len]
        for pol in ("neo", "fastdecode"):
            thr = simulate(cfg, trace, hw=hw, policy=pol, tp=tp).throughput
            row.append(round(thr / max(base, 1e-9), 3))
        rows.append(row)
    print_table(["output_len", "neo rel thr", "fastdecode rel thr"], rows)
    results["fig8b"] = rows
    save_json("fig8_fastdecode.json", results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
