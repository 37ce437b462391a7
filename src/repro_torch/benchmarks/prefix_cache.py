"""Prefix-cache benchmark of the port (the counterpart of the JAX package's
``benchmarks/prefix_cache.py``): multi-turn conversations, cache on vs off.

Drives the port's ``NeoEngine`` closed loop over the shared-system-prompt
``multiturn`` trace: a conversation's next turn goes in only after its last
one finished, so every turn resubmits the whole history and the cache
serves the decoded prefix instead of prefilling it again.  Per config:
``prefill_tok`` (prefill tokens computed; the cache must cut them >= 2x),
tok/s, and the ``PrefixCacheStats`` counters.  The cache may change what is
computed, never what is produced: greedy outputs must equal cache off's.

``--host-serving`` adds the zero-copy host-tier section: a device pool of
16 pages, far too small for the histories, so prefills land on the host
queue and their host-resident prefixes must be served in place
(``inplace_host_hits > 0``, no host-hit PCIe bytes, no promotion, outputs
equal cache off's), and token-granular matching must serve strictly more
hit tokens than page-aligned matching.

The trace shape, pools and gates are the reference's; the model is
``--arch`` at full width on the card unless asked otherwise.  The JSON
lands in ``build/figures/prefix_cache.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.prefix_cache --smoke --device cpu --quick
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

from repro_torch.benchmarks.common import (add_engine_args, engine_inputs, engine_opts,
                                           engine_overrides, print_table, save_json)
from repro_torch.config import EngineConfig
from repro_torch.core.engine import EngineStats, NeoEngine
from repro_torch.core.prefix_cache import PrefixCacheStats
from repro_torch.serving.traces import multiturn_trace


def build_conversations(n: int, turns: int, seed: int, vocab: int):
    """[(turn_order_key, prompt, output_len)] grouped by conversation."""
    trace = multiturn_trace(
        n, rate=1e9, seed=seed, turns=turns, vocab=min(vocab, 500),
        # prefill-heavy shape: long shared histories, short answers (the
        # agent/chat regime the prefix cache targets)
        system_len=384, context_len=96, user_len_median=64,
        output_median=10, max_output=16,
    )
    convs = defaultdict(list)
    for t in trace:
        convs[t.conv].append(t)
    for c in convs.values():
        # turn order within a conversation = prompt-length order (each turn
        # strictly extends the previous one)
        c.sort(key=lambda t: t.prompt_len)
    return list(convs.values())


def drive(eng: NeoEngine, conversations):
    """Closed-loop driver on a virtual clock: round-robin over the
    conversations; a conversation's next turn goes in only after its last
    one finished (different conversations still batch together).  Returns
    (outputs, total_tokens)."""
    outputs = {}
    total_tokens = 0
    cursors = [0] * len(conversations)
    pending = {}  # rid -> conv index
    while True:
        busy = set(pending.values())
        for ci, conv in enumerate(conversations):
            if cursors[ci] < len(conv) and ci not in busy:
                t = conv[cursors[ci]]
                rid = eng.submit(t.prompt, t.output_len)
                pending[rid] = ci
                busy.add(ci)
                cursors[ci] += 1
                total_tokens += t.prompt_len + t.output_len
        if not pending:
            break
        eng.step(now=eng.clock + 1e-3)
        for rid in list(pending):
            req = eng.requests[rid]
            if req.state.name in ("FINISHED", "ABORTED"):
                outputs[(pending.pop(rid), len(req.prompt))] = list(req.out_tokens)
    return outputs, total_tokens


def run(prefix_cache: bool, conversations, warmup, *, params, cfg, device,
        device_pages: int, host_pages: int, seed: int = 0,
        token_granular: bool = True, ewma_alpha=None):
    ecfg = EngineConfig(
        device_pool_pages=device_pages, host_pool_pages=host_pages,
        max_batch_tokens=2048, policy="neo", prefix_cache=prefix_cache,
        prefix_token_granular=token_granular,
        seed=seed, **engine_overrides(ewma_alpha),
    )
    eng = NeoEngine(cfg, ecfg, params=params, device=device)
    # warmup: same-shaped disjoint conversations take every path once (the
    # suffix prefills included) and settle the tree into steady state
    drive(eng, warmup)
    eng.stats = EngineStats()
    if eng.prefix_cache is not None:
        eng.prefix_cache.stats = PrefixCacheStats()

    t0 = time.perf_counter()
    outputs, total_tokens = drive(eng, conversations)
    wall = time.perf_counter() - t0
    stats = eng.prefix_cache.stats if eng.prefix_cache else None
    res = {
        "prefix_cache": prefix_cache,
        "prefill_tok": eng.stats.prefill_tokens,
        "token_throughput": round(total_tokens / wall, 1),
        "wall_s": round(wall, 2),
        "iterations": eng.stats.iterations,
        "hit_rate": round(stats.hit_rate, 3) if stats else 0.0,
        "hit_tokens": stats.hit_tokens if stats else 0,
        "promoted": stats.promoted_pages if stats else 0,
        "demoted": stats.demoted_pages if stats else 0,
        "evicted": stats.evicted_pages if stats else 0,
        "cow": stats.cow_copies if stats else 0,
        # zero-copy host-tier serving
        "inplace_host_hits": stats.inplace_host_hits if stats else 0,
        "host_served_hit_tokens": stats.host_served_hit_tokens if stats else 0,
        "host_hit_pcie_bytes": stats.host_hit_pcie_bytes if stats else 0,
    }
    eng.close()
    return res, outputs


def run_host_serving(conversations, warmup, *, host_pages: int, outputs=None,
                     page_aligned: bool = True, **common) -> tuple:
    """``--host-serving``: (1) zero-PCIe host serving with a device pool
    smaller than one history (in-place host hits > 0, no host-hit PCIe
    bytes, no promotion, outputs equal cache off's); (2) token-granular vs
    page-aligned matching on the same trace (strictly more hit tokens).
    ``common`` carries ``run``'s params, cfg, device and engine overrides;
    ``outputs``, when given, receives the cache-off and cache-on outputs
    (``hs_cache_off``, ``hs_cache_on``); without ``page_aligned`` the
    page-aligned run and its gate (2) are left out.  Returns (rc, results)."""
    small_dev = 16
    common = dict(common, device_pages=small_dev, host_pages=host_pages)
    rows, results = [], {}
    off, off_out = run(False, conversations, warmup, **common)
    on, on_out = run(True, conversations, warmup, **common)
    runs = [("hs_cache_off", off), ("hs_cache_on", on)]
    if page_aligned:
        aligned, _ = run(True, conversations, warmup, token_granular=False, **common)
        runs.append(("hs_page_aligned", aligned))
    if outputs is not None:
        outputs.update(hs_cache_off=off_out, hs_cache_on=on_out)
    for key, r in runs:
        results[key] = r
        rows.append([key, r["prefill_tok"], r["hit_rate"], r["hit_tokens"],
                     r["inplace_host_hits"], r["host_served_hit_tokens"],
                     r["host_hit_pcie_bytes"], r["promoted"]])
    print("=== Host-tier serving (multiturn closed-loop, device pool "
          f"{small_dev} pages) ===")
    print_table(["config", "prefill tok", "hit rate", "hit tok", "inplace",
                 "host served", "hit PCIe B", "promo"], rows)

    rc = 0
    same = off_out == on_out
    results["hs_outputs_identical"] = same
    if not same:
        print("FAIL: host-served outputs differ from cache-off outputs")
        rc = 1
    if on["inplace_host_hits"] <= 0:
        print("FAIL: no in-place host-served prefix hits "
              "(inplace_host_hits == 0)")
        rc = 1
    if on["host_hit_pcie_bytes"] > 0 or on["promoted"] > 0:
        print(f"FAIL: host-resident prefix hits crossed PCIe "
              f"({on['host_hit_pcie_bytes']} B, promoted "
              f"{on['promoted']} pages)")
        rc = 1
    if not page_aligned:
        return rc, results
    gain = on["hit_tokens"] - aligned["hit_tokens"]
    results["hs_token_granular_extra_hit_tokens"] = gain
    print(f"token-granular extra hit tokens vs page-aligned: {gain}")
    if gain <= 0:
        print("FAIL: token-granular matching did not increase hit tokens "
              "over page-aligned matching")
        rc = 1
    return rc, results


def run_section(n: int = 12, turns: int = 4, *, device_pages: int = 96,
                host_pages: int = 256, host_serving: bool = False,
                arch: str = "qwen3-0.6b", smoke: bool = False, dtype=None, layers=None,
                device=None, params=None, seed: int = 0, ewma_alpha=None, outputs=None,
                page_aligned: bool = True) -> tuple:
    """Cache off vs on (and, with ``host_serving``, the host-tier section):
    ``main``'s work without its file.  Returns (rc, results): rc 1 when
    the outputs differ, the prefill reduction is under 2x or a host-serving
    gate fails.  ``outputs``, when given, receives every compared run's
    outputs (``cache_off``, ``cache_on``, ``hs_cache_off``, ``hs_cache_on``);
    ``page_aligned`` as in :func:`run_host_serving`."""
    cfg, dev, params = engine_inputs(arch, smoke=smoke, dtype=dtype, layers=layers,
                                     device=device, params=params, seed=seed)
    conversations = build_conversations(n, turns, seed=0, vocab=cfg.vocab_size)
    warmup = build_conversations(max(4, n // 2), turns, seed=7, vocab=cfg.vocab_size)
    common = dict(params=params, cfg=cfg, device=dev, seed=seed, ewma_alpha=ewma_alpha)

    rows, results = [], {}
    outs = {}
    for cache in (False, True):
        key = "cache_on" if cache else "cache_off"
        r, outs[cache] = run(cache, conversations, warmup, device_pages=device_pages,
                             host_pages=host_pages, **common)
        results[key] = r
        rows.append([key, r["prefill_tok"], r["token_throughput"], r["wall_s"],
                     r["hit_rate"], r["hit_tokens"], r["promoted"],
                     r["demoted"], r["evicted"], r["cow"]])
    print(f"=== Prefix cache (multiturn closed-loop, {cfg.name}) ===")
    print_table(["config", "prefill tok", "tok/s", "wall s", "hit rate",
                 "hit tok", "promo", "demo", "evict", "cow"], rows)

    if outputs is not None:
        outputs.update(cache_off=outs[False], cache_on=outs[True])
    same = outs[False] == outs[True]
    reduction = results["cache_off"]["prefill_tok"] / max(
        1, results["cache_on"]["prefill_tok"])
    print(f"prefill-token reduction: {reduction:.2f}x; "
          f"outputs identical: {same}")
    results["prefill_reduction"] = round(reduction, 2)
    results["outputs_identical"] = same

    rc = 0
    if host_serving:
        rc, hs_results = run_host_serving(conversations, warmup, host_pages=host_pages,
                                          outputs=outputs, page_aligned=page_aligned,
                                          **common)
        results.update(hs_results)
    if not same:
        print("FAIL: cached outputs differ from cold outputs")
        rc = 1
    elif reduction < 2.0:
        print("FAIL: prefill-token reduction < 2x on the multiturn trace")
        rc = 1
    return rc, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12, help="total turns")
    ap.add_argument("--turns", type=int, default=4, help="turns/conversation")
    ap.add_argument("--device-pages", type=int, default=96)
    ap.add_argument("--host-pages", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--host-serving", action="store_true",
                    help="also run the zero-copy host-serving section: "
                         "in-place host hits with 0 promotion PCIe bytes + "
                         "token-granular vs page-aligned hit-token gate")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    n = 8 if args.quick else args.n
    rc, results = run_section(n, args.turns, device_pages=args.device_pages,
                              host_pages=args.host_pages, host_serving=args.host_serving,
                              **engine_opts(args))
    save_json("prefix_cache.json", results)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
