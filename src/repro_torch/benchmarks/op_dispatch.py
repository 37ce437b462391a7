"""What the kernels' ``torch.library`` custom ops cost on the host.  Each
kernel wrapper routes a CUDA tensor through its op (``repro_torch::...``,
whose real implementation is the ctypes launch), so that a traced step
(``repro_torch.launch.dryrun``) passes through the wrapper; this measures
what that dispatch adds over calling the launch directly:

* per call: each wrapper's host time through its op and with the op
  bypassed (the wrapper calling its ``_launch``), at the main path's shapes
  (``benchmarks/kernels.py``'s "main" cases), ``--calls`` calls a sample,
  the two ways alternating over ``--samples`` samples;
* per decode step: the pipelined full-width qwen3-0.6b engine (8 requests,
  pools 64 / 512 pages) after its prefills, the two ways on alternate steps
  (so the host's speed and the batch's growth cancel), ``--steps`` each.

Not one of the reference's benchmarks: the port's check of its own
dispatch.  One JSON line (medians in microseconds and milliseconds).

  PYTHONPATH=src python -m repro_torch.benchmarks.op_dispatch
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import card_line
from repro_torch.benchmarks.kernels import CASES, kernel_fns


def _kernel_modules():
    from repro_torch.kernels.flash_prefill import ops as flash
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.paged_decode import ops as paged
    from repro_torch.kernels.rwkv6_scan import ops as rwkv

    return {"paged_decode": paged, "flash_prefill": flash, "rwkv6_scan": rwkv,
            "mamba2_ssd": ssd}


@contextlib.contextmanager
def bypassed(modules):
    """Every wrapper in ``modules`` calling its ctypes launch directly."""
    saved = [(m, m.OP) for m in modules]
    try:
        for m in modules:
            m.OP = m._launch
        yield
    finally:
        for m, op in saved:
            m.OP = op


def _sample_us(fn, args, calls: int) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def per_call(calls: int, samples: int) -> dict:
    """{kernel: host µs a call through the op and bypassed (medians)}."""
    mods = _kernel_modules()
    out = {}
    for name, label, dt_name, case, shape in CASES:
        if label != "main":
            continue
        args = case("cuda", getattr(torch, dt_name), **shape)[0]
        kern = kernel_fns(name)[0]
        for _ in range(5):  # builds the kernel; warms both ways
            kern(*args)
            with bypassed([mods[name]]):
                kern(*args)
        op, direct = [], []
        for _ in range(samples):
            op.append(_sample_us(kern, args, calls))
            with bypassed([mods[name]]):
                direct.append(_sample_us(kern, args, calls))
        out[name] = {"op_us": statistics.median(op), "direct_us": statistics.median(direct),
                     "op_minus_direct_us": statistics.median(op) - statistics.median(direct)}
    return out


def per_step(steps: int) -> dict:
    """Host ms of the pipelined qwen3-0.6b engine's decode steps, the ops
    and the bypass on alternate steps."""
    from repro_torch.config import EngineConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NeoEngine
    from repro_torch.kernels.paged_decode import ops as paged
    from repro_torch.serving.traces import TraceRequest

    mods = list(_kernel_modules().values())
    cfg = get_config("qwen3-0.6b")
    engine = NeoEngine(cfg, EngineConfig(device_pool_pages=64, host_pool_pages=512, policy="neo",
                                         pipeline=True, hw_profile="h100_sxm", seed=0),
                       device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(8):
        t = TraceRequest(0.0, int(rng.integers(256, 769)), 2 * steps + 8)
        t.materialise(rng, cfg.vocab_size)
        engine.submit(t.prompt, t.output_len)
    while any(not r.out_tokens for r in engine.requests.values()):
        engine.step()
    torch.cuda.synchronize()
    times = {"op": [], "direct": []}
    k1 = paged.paged_decode_attention.launches
    for i in range(2 * steps):
        way = "direct" if i % 2 else "op"
        with bypassed(mods) if way == "direct" else contextlib.nullcontext():
            t = time.perf_counter()
            engine.step()
            times[way].append((time.perf_counter() - t) * 1e3)
    k1 = paged.paged_decode_attention.launches - k1
    engine.close()
    op, direct = statistics.median(times["op"]), statistics.median(times["direct"])
    return {"steps_each": steps, "op_ms": op, "direct_ms": direct,
            "op_minus_direct_ms": op - direct, "k1_launches": k1,
            "k1_launches_per_step": k1 / (2 * steps), "op_ms_runs": times["op"],
            "direct_ms_runs": times["direct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--samples", type=int, default=9)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("op_dispatch measures the card: no CUDA device")
    res = {"card": card_line(), "torch": torch.__version__,
           "per_call": per_call(args.calls, args.samples), "per_step": per_step(args.steps)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
