"""Tensor-parallel serving A/B of the port (the counterpart of the JAX
package's ``benchmarks/engine_sharded.py``): TP=1 against TP=2 on the same
swap-heavy trace (device pool 10 pages, host 128; prompts of 24 + 3i
tokens, 12 outputs).

Gather-TP column-shards the QKV and gate/up projections and concatenates
the shards' outputs before the replicated O/down projections, so greedy
decode at TP=2 must be bitwise that of TP=1, and the per-shard copy streams
must partition the swap bytes exactly.  Gates:

* ``tp2_bitwise_ok``: greedy outputs equal across TP=1 and TP=2;
* ``swap_bytes_equal``: the PCIe byte totals (out and in) equal;
* ``stream_split_exact``: TP=2's per-shard streams (``out0``/``out1``/
  ``in0``/``in1``) sum exactly to the direction totals.

Both engines run in this process.  The shards come from
``launch.mesh.shard_devices``: ``tp`` x the CPU with ``--device cpu``, the
first ``tp`` cards, or ``tp`` x ``cuda:0`` on a machine with fewer cards.
The JSON lands in ``build/figures/engine_sharded.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_sharded --smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (add_engine_args, engine_inputs, engine_opts,
                                           engine_overrides, print_table, save_json)
from repro_torch.config import EngineConfig
from repro_torch.core.engine import NeoEngine
from repro_torch.core.request import RequestState
from repro_torch.launch.mesh import shard_devices


def tp_devices(tp: int, device: torch.device):
    """The shard devices of a ``tp``-way engine on ``device``: the first
    ``tp`` cards when there are that many, else ``tp`` x ``device`` (every
    shard on one card, as on a one-card machine)."""
    if device.type == "cuda" and tp > torch.cuda.device_count():
        return shard_devices(tp, device, [device] * tp)
    return shard_devices(tp, device)


def run_tp(tp: int, n: int, *, cfg, device, params, seed: int = 0,
           ewma_alpha=None) -> dict:
    ecfg = EngineConfig(device_pool_pages=10, host_pool_pages=128,
                        max_batch_tokens=1024, policy="neo", tp=tp, seed=seed,
                        **engine_overrides(ewma_alpha))
    eng = NeoEngine(cfg, ecfg, params=params, device=device,
                    shard_devices=tp_devices(tp, device))
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, size=24 + 3 * i).tolist(), 12)
            for i in range(n)]
    t0 = time.perf_counter()
    for _ in range(600):
        eng.step()
        if all(eng.requests[r].state == RequestState.FINISHED for r in rids):
            break
    wall = time.perf_counter() - t0
    toks = sum(len(eng.requests[r].out_tokens) for r in rids)
    ts = eng.transfer.stats
    res = {
        "outputs": {str(r): list(map(int, eng.requests[r].out_tokens)) for r in rids},
        "swap_bytes": int(eng.pool.swap_bytes),
        "bytes_out": int(ts.bytes_out),
        "bytes_in": int(ts.bytes_in),
        "bytes_by_stream": {k: int(v) for k, v in ts.bytes_by_stream.items()},
        "tok_s": toks / max(wall, 1e-9),
    }
    eng.close()
    return res


def run(n: int = 6, *, arch: str = "qwen3-0.6b", smoke: bool = False, dtype=None,
        layers=None, device=None, params=None, seed: int = 0, ewma_alpha=None) -> dict:
    """TP=1 then TP=2 on the same trace and weights; the gates' dict (the
    reference's keys) plus each side's outputs under ``outputs``."""
    cfg, dev, params = engine_inputs(arch, smoke=smoke, dtype=dtype, layers=layers,
                                     device=device, params=params, seed=seed)
    common = dict(cfg=cfg, device=dev, params=params, seed=seed, ewma_alpha=ewma_alpha)
    tp1, tp2 = run_tp(1, n, **common), run_tp(2, n, **common)
    streams = tp2["bytes_by_stream"]
    out_split = {k: v for k, v in streams.items() if k.startswith("out")}
    in_split = {k: v for k, v in streams.items() if k.startswith("in")}
    return {
        "tp2_bitwise_ok": tp1["outputs"] == tp2["outputs"],
        "swap_bytes_equal": (
            tp1["swap_bytes"] == tp2["swap_bytes"]
            and tp1["bytes_out"] == tp2["bytes_out"]
            and tp1["bytes_in"] == tp2["bytes_in"]),
        "swap_bytes": tp1["swap_bytes"],
        "bytes_out": tp1["bytes_out"],
        "bytes_in": tp1["bytes_in"],
        "tp2_copy_streams": streams,
        "stream_split_exact": (
            sum(out_split.values()) == tp2["bytes_out"]
            and sum(in_split.values()) == tp2["bytes_in"]
            and len(out_split) == 2),
        "tp1_tok_s": round(tp1["tok_s"], 1),
        "tp2_tok_s": round(tp2["tok_s"], 1),
        "outputs": {"tp1": tp1["outputs"], "tp2": tp2["outputs"]},
    }


def check(res: dict) -> int:
    """The gates' verdict: 0, or 1 with each failure printed."""
    rc = 0
    if not res["tp2_bitwise_ok"]:
        print("[engine_sharded] FAIL: TP=2 greedy outputs diverge from TP=1")
        rc = 1
    if not res["swap_bytes_equal"]:
        print("[engine_sharded] FAIL: TP=2 swap byte totals differ from TP=1")
        rc = 1
    if not res["stream_split_exact"]:
        print("[engine_sharded] FAIL: per-shard copy-stream bytes do not "
              "partition the direction totals")
        rc = 1
    if res["bytes_out"] <= 0:
        print("[engine_sharded] FAIL: the A/B trace never swapped; gates "
              "are vacuous")
        rc = 1
    if rc == 0:
        print("[engine_sharded] OK: TP=2 bitwise-identical with exact "
              "per-shard byte split")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6, help="requests per A/B run")
    add_engine_args(ap)
    args = ap.parse_args(argv)

    res = run(args.n, **engine_opts(args))
    res.pop("outputs")
    print_table(
        ["gate", "value"],
        [["tp2_bitwise_ok", res["tp2_bitwise_ok"]],
         ["swap_bytes_equal", res["swap_bytes_equal"]],
         ["stream_split_exact", res["stream_split_exact"]],
         ["bytes_out (both)", res["bytes_out"]],
         ["tp2_copy_streams", res["tp2_copy_streams"]],
         ["tp1 tok/s", res["tp1_tok_s"]],
         ["tp2 tok/s", res["tp2_tok_s"]]])
    path = save_json("engine_sharded.json", res)
    print(f"[engine_sharded] wrote {path}")
    return check(res)


if __name__ == "__main__":
    sys.exit(main())
