"""Run one cell of BENCHMARK.json on one NVIDIA GPU and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last (each number compared beside its limit,
which are also the last lines of standard error).  Without a GPU, or with
fewer than the cell asks for, it prints no result and exits 2; if JAX or the
JAX package was loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the script's own folder would shadow top-level modules: import it as
    # the package ``bench`` from the checkout's root instead
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    # the prefill's activations come and go in sizes that the caching
    # allocator would otherwise fragment beside a full KV pool
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    import torch

    from bench import harness

    spec = harness.benchmark_spec()
    cell = harness.cell_of(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    cfg = harness.config_file(cell["config"])
    mix = harness.mix_file(cell["traffic"])
    metrics = harness.metrics_for(spec, cell["name"], bool(args.trace))
    result = harness.execute(cell, cfg, mix, metrics, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T_START, log)
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        log(f"error: loaded after the window: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
