"""Aggregate the port's dry-run artifacts into the roofline tables, the
port of the JAX package's ``benchmarks/roofline_table.py``.

Reads ``experiments/dryrun_torch/*.json`` (written by
``repro_torch.launch.dryrun``) and emits the §Dry-run and §Roofline
markdown sections, in the reference's layout.  The "compile s" column is
the trace's seconds and "temp GB/chip" the counter's transient peak less
the step's outputs (``memory_analysis``).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
DRYRUN_DIR = os.path.join(HERE, "..", "..", "..", "experiments", "dryrun_torch")

ARCH_ORDER = [
    "qwen3-0.6b", "qwen3-14b", "qwen3-32b", "yi-9b", "rwkv6-7b",
    "deepseek-moe-16b", "llama4-maverick-400b-a17b", "internvl2-1b",
    "seamless-m4t-medium", "zamba2-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str = "16x16") -> List[Dict]:
    rows = []
    for path in glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}.json")):
        with open(path) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER else 99,
                             SHAPE_ORDER.index(r["shape"])))
    return rows


def fmt_seconds(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def roofline_markdown(mesh: str = "16x16") -> str:
    rows = load(mesh)
    out = [
        f"| arch | shape | kind | t_compute | t_memory | t_collective | bound | "
        f"useful/HLO | roofline-frac | resident GB/chip |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rf = r["roofline"]
        out.append(
            "| {arch} | {shape} | {kind} | {tc} | {tm} | {tx} | {b} | {ur:.3f} | "
            "{frac:.4f} | {res:.2f} |".format(
                arch=r["arch"], shape=r["shape"], kind=r["kind"],
                tc=fmt_seconds(rf["t_compute_s"]), tm=fmt_seconds(rf["t_memory_s"]),
                tx=fmt_seconds(rf["t_collective_s"]), b=rf["bottleneck"],
                ur=rf["useful_flops_ratio"], frac=rf["roofline_fraction"],
                res=r.get("resident_bytes_per_chip", 0) / 1e9,
            )
        )
    return "\n".join(out)


def dryrun_markdown(mesh: str = "16x16") -> str:
    rows = load(mesh)
    out = [
        "| arch | shape | mesh | compile s | resident GB/chip | temp GB/chip (cpu-sched) | "
        "wire GB | AR/AG/RS/A2A/CP counts |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        c = r["collectives"]
        counts = "/".join(str(c.get(f"{op}_count", 0)) for op in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        out.append(
            "| {arch} | {shape} | {mesh} | {cs:.1f} | {res:.2f} | {tmp:.2f} | {wire} | {cnt} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                cs=r["compile_s"],
                res=r.get("resident_bytes_per_chip", 0) / 1e9,
                tmp=r["memory_analysis"].get("temp_size_in_bytes", 0) / 1e9,
                wire=c.get("wire_GB", 0.0), cnt=counts,
            )
        )
    return "\n".join(out)


def main() -> None:
    for mesh in ("16x16", "2x16x16"):
        rows = load(mesh)
        if not rows:
            continue
        print(f"\n## Dry-run ({mesh}, {len(rows)} cells)\n")
        print(dryrun_markdown(mesh))
        if mesh == "16x16":
            print("\n## Roofline (single-pod)\n")
            print(roofline_markdown(mesh))


if __name__ == "__main__":
    main()
