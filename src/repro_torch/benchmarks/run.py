"""Benchmark aggregator of the port (the counterpart of the JAX package's
``benchmarks/run.py``): one section per paper figure, the kernel table and
the real-engine benchmarks.  The figures run on the host (the simulator);
the kernel table and the engine sections on the card unless ``--device
cpu``; the roofline table reads the dry-run artifacts
(``repro_torch.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick
  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick --skip-real --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweeps")
    ap.add_argument("--skip-real", action="store_true",
                    help="skip the real-engine benchmarks (the slowest sections)")
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the engine sections on the smoke config")
    args = ap.parse_args(argv)
    q = ["--quick"] if args.quick else []
    dev = ["--device", args.device] if args.device else []
    eng = dev + (["--smoke"] if args.smoke else [])
    t0 = time.time()

    from repro_torch.benchmarks import (engine_real, fig6_load_latency, fig8_fastdecode,
                                        fig9_lengths, fig10a_cpu, kernels, prefix_cache,
                                        roofline_table)

    print("#" * 70)
    print("# NEO port benchmark suite (simulator figures use the real")
    print("# scheduler + the hardware model; engine sections run the port)")
    print("#" * 70)

    sections = [
        ("Fig. 6/7 load-latency", lambda: fig6_load_latency.main(q + ["--dist"])),
        ("Fig. 8 FastDecode+", lambda: fig8_fastdecode.main(q)),
        ("Fig. 9 length grid", lambda: fig9_lengths.main(q)),
        ("Fig. 10a host bandwidth", lambda: fig10a_cpu.main(q)),
        ("Kernels", lambda: kernels.main(dev)),
    ]
    if not args.skip_real:
        sections.append(("Real engine (Fig. 10b spirit)", lambda: engine_real.main(eng)))
        sections.append(("Prefix cache (multiturn)", lambda: prefix_cache.main(q + eng)))
    sections.append(("Roofline table", lambda: roofline_table.main()))

    failures = []
    for name, fn in sections:
        print(f"\n{'=' * 70}\n== {name}\n{'=' * 70}")
        try:
            rc = fn()
            if rc:  # sections signal gate failures via nonzero return codes
                failures.append((name, f"exit {rc}"))
        except Exception as e:  # noqa: BLE001
            import traceback

            traceback.print_exc()
            failures.append((name, repr(e)))
    print(f"\n[benchmarks] done in {time.time() - t0:.0f}s; "
          f"{len(failures)} failures {failures if failures else ''}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
