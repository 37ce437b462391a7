"""Multi-pod dry run, the port of the JAX package's ``launch/dryrun.py``.

For every (architecture × input shape) cell, build the production mesh
(16×16 single-pod; 2×16×16 multi-pod) over a fake world
(``launch.mesh.make_production_mesh``), run the step once on fake tensors
laid out by their specs (``launch.cells.Cell.lower``: no storage, no
communication, no kernel launch) and record:

  * ``resident_bytes_per_chip`` — the exact per-chip bytes of every input;
  * ``memory_analysis`` — in place of XLA's ``memory_analysis()``, the
    counter's tracked peak: the bytes of the storages the step allocates
    and the largest sum of them alive at once (``OpCounter.peak_bytes``);
  * ``cost_analysis_raw`` — in place of XLA's single-visit
    ``cost_analysis()``, the counter's single-pass totals (the counter
    sees every op once as it runs, so they are the trip-corrected numbers
    too);
  * the counter's per-chip FLOPs, traffic upper bound and collectives —
    the roofline's compute term and third term; the memory term is the
    closed-form ``roofline.structural``.  The ssm and hybrid families'
    train cells are counted from four smaller traces and extrapolated
    (``launch.cells.lower_extrapolated``; the artifact names them in
    ``extrapolated_from``).

Fake ``cuda`` tensors are the default: they take the card's branches
(``rows_matmul``'s ``PREFILL_MIN_ROWS`` floor, the kernels' custom ops,
whose fake implementations count the kernel's work and launch nothing), so
the trace counts the work the card does.  ``--device cpu`` traces fake
CPU tensors (the plain versions).  Artifacts go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` (the reference's
keys) and are aggregated by ``repro_torch.benchmarks.roofline_table``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all                  # single-pod
  python -m repro_torch.launch.dryrun --all --multi-pod      # 512-rank pass
  python -m repro_torch.launch.dryrun --all --jobs 8         # a process a cell
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.config import SHAPES_BY_NAME, shapes_for_arch
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.cells import (
    EXTRAPOLATED_FAMILIES,
    build_cell,
    default_grad_accum,
    lower_extrapolated,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import build_report
from repro_torch.roofline.structural import structural_bytes

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "../../../experiments/dryrun_torch")


def _memory_summary(counter, resident: int) -> dict:
    """The counter's memory read-out under the reference's keys where one
    applies: the inputs (argument), what the step allocated and still holds
    at its end (output), the rest of the peak (temp), and the total."""
    peak = counter.peak_bytes()
    live = counter.output_bytes
    return {
        "argument_size_in_bytes": resident,
        "output_size_in_bytes": live,
        "temp_size_in_bytes": peak - live,
        "peak_allocated_in_bytes": peak,
        "total_bytes": resident + peak,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = DEFAULT_OUT, verbose: bool = True,
             kv_int8: bool = False, device: str = "cuda") -> dict:
    cfg = get_config(arch)
    if kv_int8:  # the int8 KV cache variant
        cfg = cfg.replace(kv_cache_dtype="int8", name=cfg.name + "-int8kv")
        arch = cfg.name
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.size()
    t0 = time.perf_counter()

    cell = build_cell(cfg, shape, mesh)
    t_build = time.perf_counter() - t0
    extrapolate = cell.kind == "train" and cfg.family in EXTRAPOLATED_FAMILIES
    counter = lower_extrapolated(cell, mesh, device) if extrapolate else cell.lower(mesh, device)
    t_lower = time.perf_counter() - t0 - t_build
    resident = cell.resident_bytes_per_chip()

    mem = _memory_summary(counter, resident)
    coll = counter.collective_stats()
    accum = default_grad_accum(cfg, shape, mesh) if shape.kind == "train" else 1
    sbytes = structural_bytes(cfg, shape, mesh, grad_accum=accum)
    report = build_report(
        cfg, shape, mesh_name, chips,
        flops_per_chip=counter.total_flops(),
        bytes_per_chip=sbytes["total"],
        collectives=coll,
        memory_per_chip=resident,
    )
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": cell.kind,
        "ok": True,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_lower, 2),
        "resident_bytes_per_chip": resident,
        "memory_analysis": mem,
        # the counter's single-pass totals (XLA's raw cost_analysis keys)
        "cost_analysis_raw": {"flops": counter.total_flops(),
                              "bytes accessed": counter.total_traffic_bytes(),
                              "transcendentals": 0.0},
        "hlo_flops_per_chip": counter.total_flops(),
        "hlo_traffic_upper_bound": counter.total_traffic_bytes(),
        "structural_bytes": {k: round(v) for k, v in sbytes.items()},
        "grad_accum": accum,
        "collectives": coll.summary(),
        "roofline": report.to_dict(),
    }
    if extrapolate:  # (layers, micro-batches) of the four traces counted
        result["extrapolated_from"] = [list(p) for p in counter.points]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"(build {t_build:.1f}s, trace {t_lower:.1f}s, "
              f"resident/chip {resident / 1e9:.2f} GB, "
              f"peak transient/chip {mem['peak_allocated_in_bytes'] / 1e9:.2f} GB, "
              f"bottleneck {report.bottleneck})")
        print("  memory_analysis:", json.dumps(mem))
        print("  roofline:", json.dumps({k: result["roofline"][k] for k in
              ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
               "useful_flops_ratio", "roofline_fraction")}))
        print("  collectives:", json.dumps(result["collectives"]))
    return result


def _run_parallel(cells, args) -> list:
    """Each cell in a process of its own, ``args.jobs`` at once, the
    longest first; each process's output is printed when it ends.  Returns
    the failures."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def weight(cell):  # the extrapolated train cells, then the others by depth
        cfg, kind = get_config(cell[0]), SHAPES_BY_NAME[cell[1]].kind
        return (kind == "train" and cfg.family in EXTRAPOLATED_FAMILIES, kind == "train",
                cfg.num_layers)

    def one(cell):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
               "--shape", cell[1], "--device", args.device, "--out", args.out]
        cmd += ["--multi-pod"] if args.multi_pod else []
        r = subprocess.run(cmd, capture_output=True, text=True)
        print(r.stdout + (r.stderr[-4000:] if r.returncode else ""), flush=True)
        return None if r.returncode == 0 else (cell[0], cell[1], r.stderr[-400:])

    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(one, sorted(cells, key=weight, reverse=True)))
    return [f for f in results if f is not None]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="every assigned cell")
    ap.add_argument("--kv-int8", action="store_true", help="int8 KV cache variant")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device of the fake tensors (cuda: the card's branches)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once, one process each, deepest "
                         "first (a trace is host-bound, one core a cell)")
    args = ap.parse_args(argv)

    failures = []
    if args.all:
        t0 = time.perf_counter()
        cells = [(arch, shape.name) for arch in ARCH_NAMES
                 for shape in shapes_for_arch(get_config(arch))]
        if args.jobs > 1:
            failures = _run_parallel(cells, args)
        else:
            for arch, shape in cells:
                try:
                    run_cell(arch, shape, multi_pod=args.multi_pod,
                             out_dir=args.out, device=args.device)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, repr(e)))
                    traceback.print_exc()
        print(f"\n[dryrun] {len(cells)} cells, wall {time.perf_counter() - t0:.1f} s")
        if failures:
            print(f"\n{len(failures)} FAILURES:")
            for f in failures:
                print("  ", f)
            return 1
        print("\nall cells passed")
        return 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod, out_dir=args.out,
             kv_int8=args.kv_int8, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
