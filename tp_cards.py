#!/usr/bin/env python3
"""Serve full-width qwen3-0.6b through the port's gather-TP engine across the
cards of one machine, against TP=1 and against every shard on one card.

    python3 tp_cards.py            # needs two cards or more; four for TP=4

Runs ``chip_smoke.py``'s serve trace (8 requests, prompts 256-768 tokens,
32 outputs, bf16, seeded random weights, the perf model frozen) through the
pipelined paged engine, with the device pool at 512 pages (every row on the
card) and at 64 (the neo policy offloads and swaps), each at TP=1, at TP=2
and TP=4 over ``cuda:0`` .. ``cuda:tp-1`` (the default shard devices; TP=4
only with four cards), and at TP=2 with both shards on ``cuda:0``.  Prints
one JSON line per run (makespan, TTFT, TPOT, host decodes, swap bytes per
copy stream, kernel launches, each card's peak memory), then the tokens each
run shares with TP=1 of its pools, and exits 1 unless every run emits TP=1's
tokens.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"[tp_cards] FAIL: {n} card(s); this script needs two or more", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.config import EngineConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NeoEngine
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import run_trace

    _build.build_all()
    cs.log(cs.card_line())
    for i in range(n):
        torch.zeros(1, device=f"cuda:{i}")  # a context on every card, for its memory stats
    cfg = get_config("qwen3-0.6b")
    trace = cs.make_trace(8, cfg.vocab_size)
    runs = [(tp, None) for tp in (1, 2, 4) if tp <= n] + [(2, ["cuda:0", "cuda:0"])]
    tokens, ok = {}, True
    for pages in (512, 64):
        for tp, devs in runs:
            for i in range(n):
                torch.cuda.reset_peak_memory_stats(i)
            ecfg = EngineConfig(device_pool_pages=pages, host_pool_pages=512, policy="neo",
                                pipeline=True, hw_profile="h100_sxm", seed=0, ewma_alpha=0.0,
                                tp=tp)
            engine = NeoEngine(cfg, ecfg, device="cuda", shard_devices=devs)
            m, launched, calls, _, _ = cs.drive(engine, trace, lambda e, t: run_trace(
                e, t, vocab=cfg.vocab_size))
            engine.close()
            key = (pages, tp, tuple(str(d) for d in engine.shard_devices))
            tokens[key] = {rid: list(r.out_tokens) for rid, r in engine.requests.items()}
            s = engine.stats
            cs.log(json.dumps({
                "device_pages": pages, "tp": tp, "shard_devices": list(key[2]),
                "makespan_s": m.makespan, "ttft_s": m.ttft(), "tpot_s": m.tpot(),
                "offloaded_decodes": s.offloaded_decodes, "swap_bytes": engine.pool.swap_bytes,
                "bytes_by_stream": dict(sorted(engine.transfer.stats.bytes_by_stream.items())),
                "executor_calls": calls, "kernel_launches": launched,
                "peak_mem_GB": [torch.cuda.max_memory_allocated(i) / 1e9 for i in range(n)],
                "card": cs.card_line()}))
            del engine
            cs.free_card(torch)
    for key, toks in tokens.items():
        base = next(t for k, t in tokens.items() if k[:2] == (key[0], 1))
        same = sum(a == b for rid, t in toks.items() for a, b in zip(t, base[rid]))
        total = sum(map(len, base.values()))
        ok &= same == total and toks.keys() == base.keys()
        cs.log(f"[tp_cards] pools {key[0]}/512, tp={key[1]} on {','.join(key[2])}: {same} of "
               f"{total} tokens of tp=1")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
