"""End-to-end ONLINE serving example (the JAX package's
``examples/serve_online.py`` on the port): a Poisson arrival stream of
OSC-like requests served by the real NeoEngine with batched continuous
scheduling, plus a mid-run engine "crash" recovered from the request
journal (prefill-replay).

    PYTHONPATH=src python -m repro_torch.examples.serve_online [--n 16] [--crash] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_online --full --crash

``--full`` serves full-width qwen3-0.6b instead of its smoke config.  The
reference's recovery is carried as it is: the crash fires at the first
iteration after which ``n // 2`` requests of the current engine have
finished, so when they all finish at once nothing is left to replay, and
the summary counts the recovered engine's decodes only.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.benchmarks.common import bench_config, engine_overrides
from repro_torch.config import EngineConfig
from repro_torch.core.engine import NeoEngine
from repro_torch.device import resolve_device
from repro_torch.serving.traces import osc_trace

ARCH = "qwen3-0.6b"


class VirtualClock:
    """A stand-in for ``time.perf_counter`` / ``time.sleep`` that makes a
    run's arrivals follow its loop, not the host's speed: every reading
    advances the clock by ``tick`` seconds, and ``sleep(s)`` by ``s``."""

    def __init__(self, tick: float = 0.05):
        self.t = 0.0
        self.tick = float(tick)

    def perf_counter(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def sleep(self, s: float) -> None:
        self.t += max(0.0, s)


def build_engine(cfg, params=None, *, device=None,
                 ewma_alpha: Optional[float] = None) -> NeoEngine:
    return NeoEngine(
        cfg,
        EngineConfig(device_pool_pages=32, host_pool_pages=128, max_batch_tokens=1024,
                     policy="neo", seed=0, **engine_overrides(ewma_alpha)),
        params=params,
        device=device,
    )


def request_tokens(engines: Sequence[Any], mapping: Mapping[int, int]
                   ) -> Dict[Tuple[int, ...], List[int]]:
    """Every request's generated tokens by its prompt, across an engine and
    the one that replayed its journal: a replayed request's tokens are those
    it had emitted before the crash, then the replay's (``mapping`` is
    ``replay_journal``'s {old rid: new rid}).  Works on either package's
    engines."""
    first = engines[0]
    out = {tuple(r.prompt): list(r.out_tokens) for r in first.requests.values()}
    if len(engines) > 1:
        replayed = set(mapping.values())
        new = engines[-1].requests
        for old, rid in mapping.items():
            r0 = first.requests[old]
            out[tuple(r0.prompt)] = list(r0.out_tokens) + list(new[rid].out_tokens)
        for rid, r in new.items():
            if rid not in replayed:
                out[tuple(r.prompt)] = list(r.out_tokens)
    return out


def main(argv=None, *, params: Optional[Mapping[str, Any]] = None,
         clock: Callable[[], float] = time.perf_counter,
         sleep: Callable[[float], None] = time.sleep,
         ewma_alpha: Optional[float] = None) -> Dict[str, Any]:
    """The example; returns what it served.  ``params`` replaces the seeded
    weights, ``clock``/``sleep`` the wall clock (e.g. a
    :class:`VirtualClock`'s), ``ewma_alpha`` the perf model's EWMA weight
    (0 freezes it)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_online")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--crash", action="store_true",
                    help="kill the engine mid-run and journal-recover")
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full-width qwen3-0.6b (default: its smoke config)")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the config's parameter and activation dtype")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = bench_config(ARCH, smoke=not args.full, dtype=args.dtype)
    rng = np.random.default_rng(1)
    trace = osc_trace(args.n, rate=6.0, seed=1)
    for t in trace:
        t.prompt_len = min(t.prompt_len, 200)
        t.output_len = min(t.output_len, 16)
        t.materialise(rng, cfg.vocab_size)

    def build(p):
        return build_engine(cfg, p, device=device, ewma_alpha=ewma_alpha)

    engine = build(params)
    if params is None:  # the recovered engine loads the crashed one's weights
        params = {k: v.detach() for k, v in engine.model.state_dict().items()}
    engines, mapping = [engine], {}
    pending = sorted(trace, key=lambda t: t.arrival_time)
    t0 = clock()
    i = 0
    iters = 0
    crash_at = args.n // 2 if args.crash else None
    try:
        while True:
            now = clock() - t0
            while i < len(pending) and pending[i].arrival_time <= now:
                engine.submit(pending[i].prompt, pending[i].output_len,
                              arrival_time=pending[i].arrival_time)
                i += 1
            emitted = engine.step(now=now)
            iters += 1
            done = sum(r.state.name == "FINISHED" for r in engine.requests.values())
            if emitted:
                print(f"t={now:6.2f}s iter={iters:3d} +{len(emitted):2d} tokens "
                      f"(done {done}/{i}) {engine.stats.plans[-1][:72]}")
            if crash_at is not None and done >= crash_at:
                print("\n!!! simulating engine loss — journal recovery !!!\n")
                journal = engine.export_journal()
                engine.close()
                engine = build(params)
                engines.append(engine)
                mapping = engine.replay_journal(journal)
                print(f"recovered {len(mapping)} unfinished requests by prefill-replay")
                crash_at = None
            if i >= len(pending) and engine.scheduler.num_queued == 0:
                break
            if not emitted and i < len(pending):
                sleep(max(0.0, pending[i].arrival_time - (clock() - t0)))
    finally:
        engine.close()

    s = engine.stats
    makespan = clock() - t0
    print(f"\nserved {args.n} requests in {makespan:.1f}s — "
          f"offloaded {s.offloaded_decodes} decodes, device {s.device_decodes}, "
          f"modes {s.mode_counts}")
    return {"served": args.n, "recovered": len(mapping), "crashed": len(engines) > 1,
            "replayed": [tuple(engines[0].requests[old].prompt) for old in mapping],
            "makespan_s": makespan, "iterations": iters,
            "tokens": request_tokens(engines, mapping),
            "plans": [list(e.stats.plans) for e in engines],
            "stats": {"offloaded_decodes": s.offloaded_decodes,
                      "device_decodes": s.device_decodes, "modes": dict(s.mode_counts)}}


if __name__ == "__main__":
    main()
