"""Quickstart: NEO offloading in ~40 lines (the JAX package's
``examples/quickstart.py`` on the port).

Build a small model, start the NEO engine with a deliberately tiny device
KV pool, submit a few requests, and watch the scheduler offload decode
attention to the host — with outputs identical to a no-offload run.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --full --dtype float32

``--full`` serves full-width qwen3-0.6b (28 layers) instead of its smoke
config; the pools, prompts and 8 new tokens stay the reference's.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping, Optional

import numpy as np

from repro_torch.benchmarks.common import bench_config, engine_overrides
from repro_torch.config import EngineConfig
from repro_torch.core.engine import NeoEngine
from repro_torch.device import resolve_device

ARCH = "qwen3-0.6b"  # any of the 10 assigned architectures
SEED = 42  # the reference's jax.random.key(42)


def run(cfg, device, *, params: Optional[Mapping[str, Any]] = None,
        ewma_alpha: Optional[float] = None) -> Dict[str, Any]:
    """Serve the three prompts under gpu_only, then neo, printing each
    engine's counters; returns the tokens by policy, the counters and
    whether NEO's tokens equal GPU-only's (not asserted here)."""
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (40, 64, 90)]

    outputs, stats = {}, {}
    for policy in ("gpu_only", "neo"):
        engine = NeoEngine(
            cfg,
            EngineConfig(
                device_pool_pages=8,    # tiny device pool -> forces offloading
                host_pool_pages=128,    # big host DRAM pool
                max_batch_tokens=256,
                policy=policy,
                seed=SEED,  # the random weights' torch.Generator seed
                **engine_overrides(ewma_alpha),
            ),
            params=params,
            device=device,
        )
        try:
            for p in prompts:
                engine.submit(p, max_new_tokens=8)
            outputs[policy] = engine.run_until_done()
        finally:
            engine.close()
        s = engine.stats
        print(f"[{policy:8s}] iterations={s.iterations} "
              f"offloaded_decodes={s.offloaded_decodes} "
              f"device_decodes={s.device_decodes} "
              f"swap_MB={engine.pool.swap_bytes / 1e6:.1f} "
              f"modes={s.mode_counts}")
        stats[policy] = {"iterations": s.iterations, "offloaded_decodes": s.offloaded_decodes,
                         "device_decodes": s.device_decodes,
                         "swap_bytes": engine.pool.swap_bytes, "modes": dict(s.mode_counts)}

    same = all(outputs["neo"][r] == outputs["gpu_only"][r] for r in outputs["neo"])
    return {"outputs": outputs, "stats": stats, "same": same}


def main(argv=None, *, params: Optional[Mapping[str, Any]] = None,
         ewma_alpha: Optional[float] = None) -> Dict[str, Any]:
    """The example: ``params`` replaces the seeded weights and
    ``ewma_alpha`` the perf model's EWMA weight (0 freezes it)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full-width qwen3-0.6b (default: its smoke config)")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the config's parameter and activation dtype")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    res = run(bench_config(ARCH, smoke=not args.full, dtype=args.dtype), device,
              params=params, ewma_alpha=ewma_alpha)
    print(f"\nNEO outputs identical to GPU-only: {res['same']}")
    print("first request tokens:", res["outputs"]["neo"][0])
    assert res["same"], "offloading must never change results"
    return res


if __name__ == "__main__":
    main()
