#!/usr/bin/env python3
"""Serve rwkv6-7b and zamba2-7b through two checkouts of the port on one card,
in turns, and compare their ssm serve phases.

    python3 ssm_serve_ab.py OTHER_CHECKOUT [--rounds 2] [--arch rwkv6-7b zamba2-7b]

Each round runs OTHER, this checkout, this checkout, OTHER, every run a fresh
process that builds its checkout's kernels, serves two warm-up requests and
then ``chip_smoke.py``'s ssm serve phase (8 requests, the same trace and
seeded random weights in every run).  The host's speed moves these numbers
between machines (the one-token decode step is host-bound), so only runs of
one call are compared.  Each run then times one prefill of a 768-token
prompt: its wall time (synchronised), the device time of all its kernels
and of the scan kernels' alone (torch.profiler), which do not depend on the
host's speed.  Prints one JSON line per run and, last, the medians of each
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = """
import json, re, sys, time, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core.engine import NeoEngine
from repro_torch.kernels import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config(sys.argv[1])
cs.ssm_serve_phase(torch, cfg, "cuda", n=2)
summary, _ = cs.ssm_serve_phase(torch, cfg, "cuda")
model = NeoEngine(cfg, cs.ssm_engine_config(), device="cuda").model
tok = torch.randint(1, cfg.vocab_size, (1, 768), generator=torch.Generator().manual_seed(0))
tok = tok.cuda()
with torch.inference_mode():
    model.prefill(tok, capacity=cs.SSM_CAPACITY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(tok, capacity=cs.SSM_CAPACITY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(tok, capacity=cs.SSM_CAPACITY)
        torch.cuda.synchronize()
scan = re.compile(r"ssd_|rwkv_|mamba2_ssd_kernel|rwkv6_scan_kernel")
dev = [(e.key, getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0))
       for e in prof.key_averages()]
summary["prefill768"] = {"wall_ms": wall * 1e3, "device_ms": sum(t for _, t in dev) / 1e3,
                         "scan_ms": sum(t for k, t in dev if scan.search(k)) / 1e3}
print("AB " + json.dumps(summary))
"""
KEYS = ("ttft_s", "prefill_s", "serial_s", "makespan_s", "prefill768_wall_ms",
        "prefill768_device_ms", "prefill768_scan_ms")


def run(tree: str, arch: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, arch], cwd=tree, capture_output=True,
                         text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"{tree} {arch} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    s = json.loads(lines[-1][3:])
    return {"ttft_s": s["ttft_s"], "prefill_s": s["lane_busy_s"]["prefill"],
            "serial_s": s["lane_busy_s"]["serial"], "makespan_s": s["makespan_s"],
            **{"prefill768_" + k: v for k, v in s["prefill768"].items()},
            "launches": s["kernel_launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--arch", nargs="+", default=["rwkv6-7b", "zamba2-7b"])
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {}
    for arch in args.arch:
        runs = {"other": [], "this": []}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                r = run(other if side == "other" else HERE, arch)
                runs[side].append(r)
                print(json.dumps({"arch": arch, "side": side, **r}), flush=True)
        result[arch] = {side: {k: statistics.median(r[k] for r in rs) for k in KEYS}
                        for side, rs in runs.items()}
    print(json.dumps({"ab_medians": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
