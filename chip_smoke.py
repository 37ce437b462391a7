#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:

1. setup   — versions, the card's name and power limit, build the four CUDA
             kernels from the sources in this checkout (one nvcc per source,
             all started together) and print each kernel's registers, shared
             memory and spills;
2. kernel  — hold each kernel against its plain PyTorch version over a
             shape/length/dtype sweep: paged decode attention (and a row's
             output bitwise the same alone and in batches of 8 and 64) and
             flash prefill attention (the bf16 tensor-core kernel and the
             fp32 CUDA-core kernel; each with a library yardstick,
             scaled_dot_product_attention, which the port never calls), the
             RWKV6 chunked scan and the Mamba2 SSD chunked scan (three
             launches each: chunk states, state passing, chunk outputs;
             ragged lengths, T = 1, 15 and 4096, three rows, 113 heads,
             P != N, strong decay, RWKV6 decays below FLT_MIN (w = 1e-40
             on every 7th token) and the full-width shapes included, each
             case also bitwise equal over two calls; no single PyTorch call
             computes either recurrence, so they have no library
             yardstick); time kernel and plain version at the main path's
             shapes (paged decode also at 4, 8, 16 and 32 pages per range;
             flash prefill also at a FLOP-bound S = 4096 and in fp32; the
             scans also in fp32 and at T = 4096, with each stage's device
             time from torch.profiler); and paged decode and flash prefill
             at the moe, vlm and audio paths' shapes (deepseek-moe-16b's
             one query head per KV head, internvl2-1b's seven at hd 64,
             seamless-m4t-medium's non-causal encoder over 1,024 frames and
             its decoder), checked in fp32 and bf16 and timed in bf16;
3. serve   — the port's paths, each driven through ``launch.serve`` with
             every kernel's launch counter zeroed just before and read just
             after: full-width qwen3-0.6b (bf16, ``SERVE_LAYERS`` of its 28
             layers here and in 3b) through the serial paged
             engine with a device pool small enough that the neo policy must
             offload; the same trace and pools through the pipelined engine
             (async swaps, host lanes, plan-ahead: the default ``serve``),
             whose bf16 tokens must equal the serial run's bitwise;
             a short open-loop run (``run_online``, Poisson arrivals) on the
             pipelined engine; then full-width rwkv6-7b and zamba2-7b (bf16)
             through the contiguous engine, whose every prefill runs the scan
             kernel once per layer, three stage launches each (and zamba2's
             shared attention the flash prefill kernel once per
             application); random weights from a
             seeded torch.Generator;
3b. traced  — the pipelined qwen3-0.6b phase (same trace, pools, weights)
             and the rwkv6-7b phase again with engine tracing on: tokens
             bitwise equal to the untraced run's, ``obs.reconcile`` of the
             spans against EngineStats ok, no event dropped, and the
             qwen3 trace's Chrome export accepted by ``obs.validate`` with a
             host lane, a copy stream and an adopted plan; then the card's
             busy share and its five kernels with the most time, from
             torch.profiler over 8 decode steps of an untraced pipelined
             qwen3-0.6b run;
3c. prefix  — the two-tier radix prefix cache on the pipelined engine:
             full-width qwen3-0.6b over 12 multiturn requests (3
             conversations of 4 turns sharing a 384-token system prompt, the
             reference benchmark's prefill-heavy shape) driven closed loop
             (``run_conversations``), device pool 80 pages, host 512: bf16
             with the cache off, then on and traced (device hits, in-place
             host hits, copy-on-write pages and demotions each > 0, prefill
             tokens at most half the cache-off run's, K2 = 28 x prefill
             calls with a cold row, K1 = 28 x batch-0 passes, reconcile and
             obs.validate ok; the tokens equal to the cache-off run's are
             counted and each differing request printed with its prefix's
             residency), then fp32 with the cache on, every token held to
             the dense oracle;
3d. spec    — speculative decoding through ``launch.serve.run_trace`` on
             the pipelined engine: (a) full-width qwen3-0.6b, bf16, pools
             512/512 (no row leaves the card), 8 repetition-heavy requests,
             32 outputs: spec off, the n-gram drafter (K <= 4), a replay
             drafter (every draft accepted) and a wrong one (none
             accepted) give bitwise equal tokens and equal pages in use,
             K1 = 28 x (decode passes + verify passes) with as many merges;
             (b) the same prompts with pools 64/512 (host pseudo-rows in
             verify passes) at 7 layers: fp32 spec on held to the dense
             oracle and equal to fp32 spec off; bf16 spec on vs off counted, each
             differing request printed with its residency; (c) qwen3-14b
             with a qwen3-0.6b draft model (``--draft-model``), both full
             width, 4 requests of 256-512 tokens, 16 outputs: tokens equal
             spec off's, K2 = 28 x draft prefills + 40 x target prefill
             calls; K1 and K2 are first held to their plain versions at
             qwen3-14b's shapes (5 query heads per KV head) and the draft
             windows in phase 2;
3e. moe/vlm — (a) full-width, full-depth deepseek-moe-16b (bf16, 16.4 B
             random parameters drawn on the card), 8 requests of 256-512
             tokens, 16 outputs, pools 64/512 (the neo policy offloads and
             a swap goes through the TransferEngine): serial, then
             pipelined; K1 = 28 x decode passes (with merges), K2 = 28 x
             prefill calls; pipelined = serial bitwise in bf16 (asserted:
             tests/test_torch_moe_card.py found each FFN row bitwise the
             same in buckets 8-64); (b) the same prompts in fp32 at full
             width and 6 layers (dense0 + 5 moe), pipelined, no recompute,
             every token held to an oracle that prefills each prompt alone
             padded to its engine batch's length (a moe layer's capacity
             follows it) with the plain attention, then decodes
             teacher-forced; (c) full internvl2-1b, 8 image requests (256
             seeded patch embeddings, then 64-256 text tokens): bf16
             pipelined with K1/K2 counted, fp32 held to the dense plain
             oracle with the same patches; (d) the int8 KV cache on
             deepseek-moe-16b (bf16, full width): every dequantised prefill
             K/V entry within half a scale step of the bf16 cache's, greedy
             agreement and largest |logit difference| over 8 steps printed;
3f. audio   — full-width seamless-m4t-medium (bf16) on the contiguous
             engine: 8 requests with 1,024 seeded frames each and prompts of
             64-256 tokens, 16 outputs; K2 = 24 x prefills (12 non-causal
             encoder + 12 causal decoder layers), no other kernel; then fp32,
             every token held to the model's own plain prefill plus
             teacher-forced decode;
3g. tp      — gather-TP tensor parallelism on the pipelined paged engine,
             every shard on cuda:0 (``shard_devices``), perf model frozen:
             K1 and K2 first held to their plain versions at the shard
             shapes (8/4, 4/2 and 20/4 query/KV heads, hd 128) and timed;
             (a) full-width qwen3-0.6b bf16 at TP 1, 2 and 4, the serve
             phase's 8 requests, pools 512/512 (every row on the card):
             tokens of TP 2 and 4 = TP 1's bitwise, K1 = tp x 28 x decode
             passes, K2 = tp x 28 x prefill calls; (b) TP=2 with pools
             64/512 at 7 layers: fp32 held to the dense oracle; bf16
             traced, the
             per-shard copy streams partitioning the swaps exactly,
             obs.validate ok with hostattn-b0-s0/-s1 and copy-out0/1 tracks,
             reconcile ok; bf16 TP=1 on the same trace recorded beside it
             (the TP perf model prices two cards, so plans may differ);
             (c) qwen3-14b bf16 at TP=2 = TP=1 (4 requests of 256-512
             tokens, 16 outputs), peak memory recorded; (d) ``serve --tp``
             beyond the card count raises the device-count ValueError.
             One card says nothing of TP's speed: its shards share one H100;
3h. bench   — the reference's engine benchmarks and their gates through
             ``repro_torch.benchmarks.bench_trend.collect`` on full-width
             qwen3-0.6b at ``BENCH_LAYERS`` = 7 of its 28 layers (bf16,
             perf model frozen but for the speculation
             section, which runs it live and attends on 8 host threads; the
             reference's traces and pools in pages, its --n cut; every
             engine's width and depth asserted): micro-batching, mixed-plan lane
             borrowing, tracing, speculation, the prefix cache with
             host serving, TP 1 vs 2 and the sustained A/B; prefix cache on
             = off and the sustained loops' bitwise claims asserted in fp32
             at full width and 4 layers, their bf16 matches printed; K1/K2
             launches = shards x 7 x decode passes / prefill calls with a
             cold row per section; the summary gated against
             ``src/repro_torch/benchmarks/BENCH_baseline_h100.json``;
             engine_real's policy table (gpu_only, neo serial, neo, fastdecode)
             runs first, once, recorded, and its fastdecode burst is the
             micro-batch and tracing sections' shared run, as
             ``engine_real.main`` shares it;
3i. examples — the JAX package's examples as ``repro_torch.examples``,
             driven through their ``main``/``run`` on full-width qwen3-0.6b
             (``--full``), K1/K2 counted per run as in 3h: (a) quickstart
             (its prompts, 8 device / 128 host pages, 8 new tokens) in
             fp32, NEO's tokens = GPU-only's (the example's own assert)
             with offloaded decodes > 0, then in bf16 with the tokens
             equal to GPU-only's counted (a record); (b) serve_online
             ``--crash`` (``EXAMPLES_N`` = 9 Poisson OSC arrivals) in fp32 on a virtual
             clock with the perf model frozen: at least one request
             replayed, every request's tokens = the crash-free run's on
             the same clock; then bf16 with ``--crash`` and crash-free on
             the wall clock, served / recovered / makespan / K1 / K2 and
             the replayed requests' tokens equal to the crash-free run's
             printed (a record);
3j. train  — single-device training through ``repro_torch.train``
             (the plain attention and scans: K1-K4 launch 0 times over the
             phase, asserted): (a) full-width qwen3-0.6b at
             ``TRAIN_PARITY_LAYERS`` = 4 layers in fp32 (TF32 off), batch
             2 x 64 from ``SyntheticTokens``: one step's loss within rel
             1e-5 and every gradient within 1e-4 of the largest of the
             port's CPU path's, AdamW and Adafactor updates within 1e-6,
             6 steps in one run against 3 + checkpoint + a fresh Trainer
             resumed + 3 within 2e-5 (bitwise-equal leaves counted); (b)
             qwen3-0.6b, all 28 layers, bf16, AdamW, remat "full", batch
             8 x 512, 20 steps at lr 1e-3 (3 warmup): finite losses that
             drop by more than 1.0, the median step time after step 3,
             tokens/s, peak memory and the model-FLOP share (a record);
             (c) deepseek-moe-16b at full width, 2 layers (dense0 + one moe
             layer), fp32: loss, aux and gradients card = CPU, the only
             card check of the scatter dispatch's backward; (d)
             ``repro_torch.examples.train_mini`` at its defaults but
             ``--steps`` (``TRAIN_MINI_STEPS`` = 30 of 300, for time; 64 M
             fp32 parameters): it resumes from its checkpoint and prints
             OK;
3k. mesh   — multi-device training's path on a world of one: an ``nccl``
             group of one rank, a 1 x 1 data x model ``DeviceMesh`` and a
             ``ShardingContext`` (K1-K4 launch 0 times, asserted): (a)
             full-width qwen3-0.6b at ``MESH_LAYERS`` = 4 layers in fp32,
             batch 2 x 64: the loss and every gradient through DTensor
             parameters bitwise equal to the no-context path's, then one
             AdamW step with the ZeRO layout bitwise equal to the
             single-device step (parameters and both moments); (b)
             ``int8_allreduce_mean`` over the mesh's data axis bitwise its
             numpy oracle.  A failed ``nccl`` start or collective fails
             the script;
3l. dryrun — the dry run and the roofline tooling: (a) ``launch.dryrun.
             run_cell`` on the fake 16 x 16 world with fake cuda tensors for
             qwen3-0.6b train_4k, prefill_32k and decode_32k, rwkv6-7b and
             zamba2-7b prefill_32k, in a process of its own started first
             (it needs the host only), every cell ok and K1-K4 launched 0
             times; (b) qwen3-0.6b decode_32k at 8 rows and prefill_32k at
             1 row for real on a world-of-one ``nccl`` 1 x 1 mesh: the
             counter's FLOPs and bytes equal to the fake trace's, resident
             bytes = the real inputs', K2 28 launches in the prefill, and
             t_bound / t_step <= 1.05; prints each step's model-FLOP share;
4. parity  — each model again in fp32 on the same prompts, every emitted
             token checked against an oracle on the card that runs the plain
             attention and scans, never the kernels: the dense plain prefill
             over prompt + out[:i] for qwen3-0.6b at ``SERVE_LAYERS`` = 14
             of its 28 layers (the serial engine, then the pipelined one
             with host rows in batch-1 lanes); the model's
             own plain prefill, then teacher-forced decode steps, for
             rwkv6-7b and zamba2-7b (full width, ``SSM_PARITY_LAYERS``: 16
             of 32 and 40 of 81 layers).

Output: the card line (nvidia-smi name, power limit), per-case kernel
lines, the serve summaries, the traced phases' and the busy-share lines,
the ``{"train": {...}}``, ``{"mesh_train": {...}}`` and ``{"dryrun": {...}}``
lines, one
``{"kernels": [...]}`` line, the parity
counts, the card line again and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.  It imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.benchmarks.common import card_line as bench_card_line  # noqa: E402
from repro_torch.benchmarks.engine_real import OracleDrafter  # noqa: E402
from repro_torch.benchmarks.kernels import (BF16_FLOPS, F32_FLOPS, TOL, bound,  # noqa: E402
                                            flash_bound, mamba2_bound, paged_library_call,
                                            rwkv6_bound, time_ms)

NEAR_TIE = 1e-3  # parity: a token within this of the oracle's max logit is a tie
# depth of the host-attention-heavy repeats of the qwen3-0.6b path (full
# width): 3d (b), 3g (b) and every bf16 section of 3h, cut so that the
# whole run fits its time limit on a slower host (PERF.md §4)
HOST_PHASE_LAYERS = 7
# depth of phase 3/3b's bf16 qwen3-0.6b runs (serial, pipelined, traced,
# open loop; full width), of the phase-4 qwen3-0.6b fp32 parity (beside
# phase 3j) and of the rwkv6-7b and zamba2-7b fp32 parity, cut so
# that the whole run keeps its margin to the time limit on a slower host
# (PERF.md §4); the busy share and the bf16 ssm serve phases keep every
# layer
SERVE_LAYERS = 14
SSM_PARITY_LAYERS = {"rwkv6-7b": 16, "zamba2-7b": 40}
NO_LIBRARY = ("no single PyTorch call computes this recurrence; the port's "
              "plain version is a loop of chunk steps")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    line = bench_card_line()
    if line is None:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    return line


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


def make_case(torch, B, H, KV, hd, page, lens, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    maxp = max(1, max(-(-n // page) for n in lens))
    P = B * maxp + 1
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=g, device="cuda").to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=g, device="cuda").to(dtype)
    # each row its own shuffled pages
    perm = torch.randperm(P, generator=g, device="cuda")[: B * maxp]
    bt = perm.reshape(B, maxp).to(torch.int32).contiguous()
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, ln


def kernel_phase(torch):
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    edge = [0, 1, 16, 17, 2047, 2048, 1000, 33]
    rng = __import__("random").Random(0)
    cases = []
    for B in (1, 8, 64):
        lens = [2048] if B == 1 else (edge + [rng.randint(1, 2048) for _ in range(B)])[:B]
        cases.append(dict(B=B, H=16, KV=8, hd=128, page=16, lens=lens))
    cases.append(dict(B=8, H=14, KV=2, hd=112, page=16, lens=edge))
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, c in enumerate(cases):
            q, kp, vp, bt, ln = make_case(torch, c["B"], c["H"], c["KV"], c["hd"],
                                          c["page"], c["lens"], dtype, seed=i)
            out = kern(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            ref = paged_decode_ref(q, kp, vp, bt, ln)
            err = (out.float() - ref.float()).abs()
            tol = TOL[dt_name]
            ok = bool((err <= tol + tol * ref.float().abs()).all())
            worst[dt_name] = max(worst.get(dt_name, 0.0), float(err.max()))
            log(f"[kernel] paged_decode {dt_name} B={c['B']} H={c['H']} KV={c['KV']} "
                f"hd={c['hd']} lens={c['lens'][:8]} max_abs_err={float(err.max()):.3e} "
                f"tol={tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"paged_decode kernel disagrees with its plain "
                                     f"version ({dt_name}, case {c})")

    row_invariance(torch, kern)

    # timings at the main path's shape (8 rows of the serve phase's lengths,
    # bf16, full-width qwen3-0.6b heads) and at a long-context decode shape,
    # with the kernel also timed at other pages-per-split (the sweep that
    # chose ops.PAGES_PER_SPLIT)
    from repro_torch.kernels.paged_decode.ops import PAGES_PER_SPLIT

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {}
    for label, B, lens in (("main", 8, [rng.randint(257, 800) for _ in range(8)]),
                           ("long", 64, [2048] * 64)):
        timed[label] = decode_time(torch, flush, label, B, 16, 8, 128, lens, sweep=(4, 8, 16, 32))
        log(f"[kernel] paged_decode kernel at pages_per_split (default {PAGES_PER_SPLIT}): "
            + ", ".join(f"{k}: {v:.4f} ms" for k, v in timed[label]["pages_per_split_ms"].items()))
    return timed, worst


def decode_time(torch, flush, label, B, H, KV, hd, lens, sweep=()):
    """Kernel, plain version and the SDPA yardstick at one bf16 decode shape
    (pages of 16 tokens), the kernel's error, its bound, and the kernel at
    each pages-per-split of ``sweep``."""
    from repro_torch.kernels.paged_decode.ops import _launch as launch
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    q, kp, vp, bt, ln = make_case(torch, B, H, KV, hd, 16, lens, torch.bfloat16, seed=9)
    out = kern(q, kp, vp, bt, ln)
    err = float((out.float() - paged_decode_ref(q, kp, vp, bt, ln).float()).abs().max())
    t_k = time_ms(lambda: kern(q, kp, vp, bt, ln), flush)
    t_p = time_ms(lambda: paged_decode_ref(q, kp, vp, bt, ln), flush)
    t_l = time_ms(paged_library_call(q, kp, vp, bt, ln, 16), flush)
    by_split = {pps: time_ms(lambda: launch(q, kp, vp, bt, ln, pps), flush)
                for pps in sweep}
    b_ms, b_by = bound(q, lens, 16, KV, hd)
    log(f"[kernel] timing {label}: B={B} H={H} KV={KV} hd={hd} bf16 sum(lens)={sum(lens)} "
        f"kernel={t_k:.4f} ms plain={t_p:.4f} ms library={t_l:.4f} ms "
        f"bound={b_ms:.4f} ms ({b_by}) max_abs_err={err:.3e}")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, B=B, sum_lens=sum(lens), pages_per_split_ms=by_split,
                shape=f"B={B} H={H} KV={KV} hd={hd} page=16 bf16 sum(lens)={sum(lens)}")


def row_invariance(torch, kern):
    """A row's output is bitwise the same alone and inside batches of 8 and
    64 (other lengths, wider block tables), in fp32 and bf16: its page
    ranges depend on its own length only."""
    import random

    rng = random.Random(3)
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        g = torch.Generator(device="cuda").manual_seed(11)
        P, page = 4096, 16
        kp = torch.randn(P, page, 8, 128, generator=g, device="cuda").to(dtype)
        vp = torch.randn(P, page, 8, 128, generator=g, device="cuda").to(dtype)
        q_row = torch.randn(16, 128, generator=g, device="cuda").to(dtype)
        len_row = 1500
        pages_row = torch.randperm(P, generator=g, device="cuda")[: -(-len_row // page)]
        outs = []
        for B, where, width in ((1, 0, 94), (8, 3, 128), (64, 50, 160)):
            q = torch.randn(B, 16, 128, generator=g, device="cuda").to(dtype)
            q[where] = q_row
            lens = [rng.randint(0, width * page) for _ in range(B)]
            lens[where] = len_row
            bt = torch.randint(0, P, (B, width), generator=g, device="cuda", dtype=torch.int32)
            bt[where, : len(pages_row)] = pages_row.to(torch.int32)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            outs.append(kern(q, kp, vp, bt.contiguous(), ln)[where].clone())
        torch.cuda.synchronize()
        same = [bool(torch.equal(outs[0], o)) for o in outs[1:]]
        log(f"[kernel] paged_decode {dt_name} row bitwise equal alone / in 8 / in 64: "
            f"{[True] + same}")
        if not all(same):
            raise AssertionError(f"paged_decode ({dt_name}): a row's output changes with "
                                 "its batch")


def flash_inputs(torch, B, S, H, KV, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype)
                 for n in (H, KV, KV))


def flash_check(torch, dt_name, c, q, k, v):
    """Hold flash_prefill to its plain version on (q, k, v) at case ``c``
    (raises past TOL); returns the largest absolute error."""
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    got = flash_prefill(q, k, v, causal=c["causal"], window=c["window"])
    torch.cuda.synchronize()
    want = flash_prefill_ref(q, k, v, causal=c["causal"], window=c["window"])
    err = _close(torch, "flash_prefill", dt_name, c, [("o", got, want)])
    log(f"[kernel] flash_prefill {dt_name} {c} max_abs_err={err:.3e} "
        f"tol={TOL[dt_name]} ok")
    return err


def flash_sweep(torch, cases, seed):
    """flash_check over ``cases`` in fp32 and bf16; the worst error per dtype."""
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, c in enumerate(cases):
            q, k, v = flash_inputs(torch, c["B"], c["S"], c["H"], c["KV"], c["hd"], dtype,
                                   seed=seed + i)
            worst[dt_name] = max(worst.get(dt_name, 0.0),
                                 flash_check(torch, dt_name, c, q, k, v))
    return worst


def flash_time(torch, flush, label, B, S, H, KV, hd, window, dt_name="bfloat16", causal=True):
    """Kernel, plain version and SDPA (GQA; the port never calls it) at one
    shape in ``dt_name`` (bf16: the tensor-core kernel; fp32: the CUDA-core
    kernel, its bound at the f32 rate), causal or not, after holding the
    kernel to its plain version there; window must not cut below S (SDPA
    runs without one)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    assert window == 0 or window >= S
    q, k, v = flash_inputs(torch, B, S, H, KV, hd, getattr(torch, dt_name), seed=7)
    err = flash_check(torch, dt_name, dict(B=B, S=S, H=H, KV=KV, hd=hd, causal=causal,
                                           window=window), q, k, v)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t_k = time_ms(lambda: flash_prefill(q, k, v, causal=causal, window=window), flush)
    t_p = time_ms(lambda: flash_prefill_ref(q, k, v, causal=causal, window=window),
                  flush)
    t_l = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                enable_gqa=True), flush)
    b_ms, b_by = flash_bound(q, k, causal, window,
                             BF16_FLOPS if dt_name == "bfloat16" else F32_FLOPS)
    kind = "causal" if causal else "non-causal"
    log(f"[kernel] timing flash_prefill {label}: B={B} S={S} H={H} KV={KV} hd={hd} {kind} "
        f"window={window} {dt_name} kernel={t_k:.4f} ms plain={t_p:.4f} ms sdpa={t_l:.4f} ms "
        f"bound={b_ms:.4f} ms ({b_by}) max_abs_err={err:.3e}")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, shape=f"B={B} S={S} H={H} KV={KV} hd={hd} {kind} "
                f"window={window} {dt_name}")


def flash_kernel_phase(torch):
    """flash_prefill against its plain version over test_kernels.py's sweep,
    the window case, ragged S and the full-width shapes, fp32 and bf16; then
    timings at qwen3-0.6b's and zamba2-7b's B=1, S=512 prefill shapes."""
    cases = [dict(B=1, S=128, H=4, KV=4, hd=32, causal=c, window=0) for c in (True, False)]
    cases += [dict(B=2, S=256, H=8, KV=2, hd=64, causal=c, window=0) for c in (True, False)]
    cases += [dict(B=1, S=192, H=4, KV=1, hd=48, causal=c, window=0) for c in (True, False)]
    cases += [dict(B=1, S=128, H=4, KV=4, hd=32, causal=True, window=32),
              dict(B=2, S=100, H=8, KV=2, hd=64, causal=True, window=0),  # ragged S
              dict(B=1, S=130, H=8, KV=2, hd=64, causal=False, window=0),
              dict(B=2, S=200, H=8, KV=2, hd=64, causal=True, window=32),
              dict(B=1, S=512, H=16, KV=8, hd=128, causal=True, window=0),  # qwen3-0.6b
              dict(B=1, S=512, H=32, KV=32, hd=112, causal=True, window=32768),  # zamba2-7b
              dict(B=1, S=300, H=32, KV=32, hd=112, causal=True, window=64)]
    worst = flash_sweep(torch, cases, seed=200)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {"qwen3": flash_time(torch, flush, "qwen3-0.6b", 1, 512, 16, 8, 128, 0),
             "zamba2": flash_time(torch, flush, "zamba2-7b", 1, 512, 32, 32, 112, 32768),
             # FLOP-bound: the tensor-core rate
             "long": flash_time(torch, flush, "long prompt", 1, 4096, 16, 8, 128, 0),
             # the fp32 path's CUDA-core kernel at qwen3-0.6b's shape
             "qwen3_fp32": flash_time(torch, flush, "qwen3-0.6b", 1, 512, 16, 8, 128, 0,
                                      dt_name="float32")}
    del flush
    return timed, worst


def spec_kernel_phase(torch):
    """K1 and K2 at the speculative path's shapes, against their plain
    versions in fp32 and bf16, then timed in bf16: qwen3-14b's attention (40
    query heads over 8 KV heads, an odd 5 per group; K1 over a verify pass
    of 4 rows x 5 pseudo-rows, K2 over a prompt and over the padded batch of
    the phase's 4 prompts) and the draft model's prefill windows (qwen3-0.6b,
    S = 64 and a short one)."""
    import random

    from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    rng = random.Random(14)
    lens = [n + j for n in (rng.randint(256, 528) for _ in range(4)) for j in range(5)]
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        q, kp, vp, bt, ln = make_case(torch, 20, 40, 8, 128, 16, lens, getattr(torch, dt_name),
                                      seed=40)
        out = kern(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        err = _close(torch, "paged_decode", dt_name, "qwen3-14b verify pass",
                     [("o", out, paged_decode_ref(q, kp, vp, bt, ln))])
        worst[dt_name] = err
        log(f"[kernel] paged_decode {dt_name} qwen3-14b B=20 H=40 KV=8 hd=128 "
            f"lens={lens[:10]} max_abs_err={err:.3e} tol={TOL[dt_name]} ok")
    cases = [dict(B=1, S=512, H=40, KV=8, hd=128, causal=True, window=0),
             dict(B=4, S=509, H=40, KV=8, hd=128, causal=True, window=0),
             dict(B=1, S=64, H=16, KV=8, hd=128, causal=True, window=0),
             dict(B=1, S=37, H=16, KV=8, hd=128, causal=True, window=0)]
    flash_worst = flash_sweep(torch, cases, seed=400)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {"decode_qwen3_14b": decode_time(torch, flush, "qwen3-14b verify pass", 20, 40, 8,
                                             128, lens),
             "prefill_qwen3_14b": flash_time(torch, flush, "qwen3-14b", 1, 512, 40, 8, 128, 0),
             "prefill_draft_window": flash_time(torch, flush, "draft window", 1, 64, 16, 8, 128,
                                                0)}
    del flush
    return timed, worst, flash_worst


def p11_kernel_phase(torch):
    """K1 and K2 at the shapes the moe, vlm and audio paths hand them, held
    to their plain versions in fp32 and bf16, then timed in bf16 (L2
    flushed) beside SDPA and their bound: deepseek-moe-16b's one query head
    per KV head (hd 128), internvl2-1b's seven (hd 64; K2's bf16 kernel
    pairs query heads, so an odd count leaves one lane dead), and
    seamless-m4t-medium's non-causal encoder attention over 1,024 frames and
    its causal decoder prefill (16 heads, hd 64)."""
    import random

    from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    rng = random.Random(19)
    lens = [rng.randint(256, 528) for _ in range(8)]  # prompts of 256-512 + 16 outputs
    decode_shapes = {MOE_ARCH: (16, 16, 128), VLM_ARCH: (14, 2, 64)}
    decode_worst = {}
    for arch, (H, KV, hd) in decode_shapes.items():
        for dt_name in ("float32", "bfloat16"):
            q, kp, vp, bt, ln = make_case(torch, 8, H, KV, hd, 16, lens,
                                          getattr(torch, dt_name), seed=50 + H)
            out = kern(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            err = _close(torch, "paged_decode", dt_name, arch,
                         [("o", out, paged_decode_ref(q, kp, vp, bt, ln))])
            decode_worst[dt_name] = max(decode_worst.get(dt_name, 0.0), err)
            log(f"[kernel] paged_decode {dt_name} {arch} B=8 H={H} KV={KV} hd={hd} "
                f"lens={lens} max_abs_err={err:.3e} tol={TOL[dt_name]} ok")
    flash_worst = flash_sweep(torch, [
        dict(B=8, S=512, H=16, KV=16, hd=128, causal=True, window=0),
        dict(B=8, S=512, H=14, KV=2, hd=64, causal=True, window=0),
        dict(B=1, S=1024, H=16, KV=16, hd=64, causal=False, window=0),
        dict(B=1, S=256, H=16, KV=16, hd=64, causal=True, window=0)], seed=500)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {
        "decode_deepseek": decode_time(torch, flush, MOE_ARCH, 8, 16, 16, 128, lens),
        "decode_internvl2": decode_time(torch, flush, VLM_ARCH, 8, 14, 2, 64, lens),
        "prefill_deepseek": flash_time(torch, flush, MOE_ARCH, 1, 512, 16, 16, 128, 0),
        "prefill_internvl2": flash_time(torch, flush, VLM_ARCH, 1, 512, 14, 2, 64, 0),
        "prefill_seamless_encoder": flash_time(torch, flush, "seamless encoder", 1, 1024, 16,
                                               16, 64, 0, causal=False),
        "prefill_seamless_decoder": flash_time(torch, flush, "seamless decoder", 1, 256, 16,
                                               16, 64, 0)}
    del flush
    return timed, decode_worst, flash_worst


def _close(torch, name, dt_name, case, pairs):
    """Hold (label, kernel output, plain output) pairs to TOL; returns the
    largest absolute error."""
    tol = TOL[dt_name]
    worst = 0.0
    for label, got, want in pairs:
        err = (got.float() - want.float()).abs()
        ok = (bool(torch.isfinite(got.float()).all())
              and bool((err <= tol + tol * want.float().abs()).all()))
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if not ok:
            raise AssertionError(f"{name} kernel disagrees with its plain version on "
                                 f"{label} ({dt_name}, case {case}): max_abs_err "
                                 f"{float(err.max()):.3e}")
    return worst


def rwkv6_inputs(torch, B, T, H, N, dtype, seed, strong=False, tiny_every=0):
    """r/k/v ~ N(0, 1); decay w = exp(-exp(z)) with z ~ N(0, 1), or with
    log w around -5 per step (``strong``), which drives the pair decays into
    their +-60 clip, and w = 1e-40, below FLT_MIN, on every ``tiny_every``-th
    token; u ~ N(0, 1); state 0.1 N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, N, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    z = torch.randn(B, T, H, N, generator=g, device="cuda")
    if strong:
        z = math.log(5.0) + 0.1 * z
    w = torch.exp(-torch.exp(z))
    if tiny_every:
        w[:, ::tiny_every] = 1e-40
    u = torch.randn(H, N, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(B, H, N, N, generator=g, device="cuda")
    return r, k, v, w, u, s0


def mamba2_inputs(torch, B, T, H, P, N, dtype, seed, strong=False):
    """x, B, C ~ N(0, 1); dt ~ U(0.001, 0.1) and A ~ -U(0.5, 2) (the
    reference sweep's), or dt ~ U(1, 3) and A ~ -U(1, 3) (``strong``: log
    decay around -4 per step); D ~ N(0, 1); state 0.1 N(0, 1) as [B, H, N, P]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, H, P, generator=g, device="cuda").to(dtype)
    lo, hi = (1.0, 3.0) if strong else (0.001, 0.1)
    dt = lo + (hi - lo) * torch.rand(B, T, H, generator=g, device="cuda")
    alo, ahi = (1.0, 3.0) if strong else (0.5, 2.0)
    A = -(alo + (ahi - alo) * torch.rand(H, generator=g, device="cuda"))
    Bm = torch.randn(B, T, N, generator=g, device="cuda").to(dtype)
    Cm = torch.randn(B, T, N, generator=g, device="cuda").to(dtype)
    D = torch.randn(H, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(B, H, N, P, generator=g, device="cuda")
    return x, dt, A, Bm, Cm, D, s0


def stage_ms(torch, fn, flush, prefix, n=20):
    """Device time of each of the kernel's stages per launch (torch.profiler,
    L2 flushed before each call; every call launches each stage once), by
    kernel name.  Averaged over the launches the profiler recorded, which
    may be fewer than ``n``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"\b(" + prefix + r"\w+)", e.key)  # e.g. "...::ssd_states<...>(...)"
        if m and e.count:
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            out[m.group(1)] = t / e.count / 1e3
    return out


def scan_time(torch, name, kern, plain, make, shape, dt_name, bound, prefix, flush):
    """Kernel and plain version at ``shape``: median ms each (``time_ms``),
    the kernel's stages by the profiler, the bound, the largest error."""
    args = make(torch, dtype=getattr(torch, dt_name), seed=9, **shape)
    got, want = kern(*args), plain(*args)
    err = max(float((got[0].float() - want[0].float()).abs().max()),
              float((got[1] - want[1]).abs().max()))
    t_k = time_ms(lambda: kern(*args), flush)
    t_p = time_ms(lambda: plain(*args), flush)
    stages = stage_ms(torch, lambda: kern(*args), flush, prefix)
    b_ms, b_by = bound(args)
    log(f"[kernel] timing {name}: {shape} {dt_name} kernel={t_k:.4f} ms plain={t_p:.4f} ms "
        f"bound={b_ms:.4f} ms ({b_by}) library=none max_abs_err={err:.3e} stages_ms="
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    return dict(ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, stages_ms=stages, shape=shape, dtype=dt_name)


def scan_phase(torch, name, kern, plain, make, cases, full, long, bound, prefix):
    """Sweep ``cases`` (dicts of ``make``'s shape keywords) in f32 and bf16,
    each kernel output held to the plain version and bitwise equal over two
    calls; then time kernel and plain version at the ``full`` shape in bf16
    and f32 and at the ``long`` one in bf16 (the state walk's cost)."""
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, c in enumerate(cases):
            args = make(torch, dtype=dtype, seed=100 + i, **c)
            got = kern(*args)
            again = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = _close(torch, name, dt_name, c,
                         [("y", got[0], want[0]), ("state", got[1], want[1])])
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"{name} ({dt_name}, case {c}): two calls on the same "
                                     "inputs differ")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
            log(f"[kernel] {name} {dt_name} {c} max_abs_err={err:.3e} tol={TOL[dt_name]} "
                "ok, bitwise equal over two calls")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    t = scan_time(torch, name, kern, plain, make, full, "bfloat16", bound, prefix, flush)
    t["fp32"] = scan_time(torch, name, kern, plain, make, full, "float32", bound, prefix, flush)
    t["long"] = scan_time(torch, name, kern, plain, make, long, "bfloat16", bound, prefix, flush)
    t["max_abs_err_sweep"] = worst
    del flush
    return t, worst


def rwkv6_kernel_phase(torch):
    from repro_torch.kernels.rwkv6_scan.ops import CHUNK, rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked

    cases = [dict(B=1, T=32, H=2, N=16), dict(B=2, T=64, H=4, N=32),  # test_kernels.py:100
             dict(B=1, T=100, H=2, N=16),  # ragged T
             dict(B=2, T=40, H=3, N=64, strong=True),  # strong decay, ragged
             dict(B=2, T=70, H=3, N=32, tiny_every=7),  # w = 1e-40 < FLT_MIN, ragged
             dict(B=1, T=512, H=64, N=64, tiny_every=7),
             dict(B=1, T=1, H=4, N=64), dict(B=1, T=15, H=4, N=64),  # one token, one part-chunk
             dict(B=1, T=4096, H=4, N=64),  # 64 state chunks
             dict(B=3, T=100, H=113, N=64),  # three rows, many heads
             dict(B=1, T=512, H=64, N=64), dict(B=1, T=768, H=64, N=64)]  # full width
    return scan_phase(torch, "rwkv6_scan", rwkv6_scan,
                      lambda *a: rwkv6_chunked(*a, chunk=CHUNK), rwkv6_inputs, cases,
                      dict(B=1, T=512, H=64, N=64), dict(B=1, T=4096, H=64, N=64), rwkv6_bound,
                      "rwkv_")


def mamba2_kernel_phase(torch):
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK, _launch, mamba2_ssd
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked

    cases = [dict(B=1, T=32, H=2, P=16, N=16), dict(B=2, T=64, H=2, P=32, N=32),  # :137
             dict(B=1, T=100, H=3, P=32, N=16),  # ragged T, P != N (the smoke shape)
             dict(B=2, T=130, H=4, P=24, N=40, strong=True),  # strong decay, P != N
             dict(B=1, T=1, H=4, P=64, N=64), dict(B=1, T=15, H=4, P=64, N=64),
             dict(B=1, T=4096, H=8, P=64, N=64),  # 64 chunks
             dict(B=3, T=100, H=113, P=64, N=64),  # three rows, a partial group of heads
             dict(B=1, T=512, H=112, P=64, N=64), dict(B=1, T=768, H=112, P=64, N=64)]
    t, worst = scan_phase(torch, "mamba2_ssd", mamba2_ssd,
                          lambda *a: mamba2_ssd_chunked(*a, chunk=CHUNK), mamba2_inputs, cases,
                          dict(B=1, T=512, H=112, P=64, N=64),
                          dict(B=1, T=4096, H=112, P=64, N=64), mamba2_bound, "ssd_")
    # heads per block of stages 1 and 3 (ops.HEADS_PER_BLOCK is the default)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    args = mamba2_inputs(torch, B=1, T=512, H=112, P=64, N=64, dtype=torch.bfloat16, seed=9)
    t["heads_per_block_ms"] = {hg: time_ms(lambda: _launch(*args, heads_per_block=hg),
                                           flush) for hg in (1, 2, 4, 8)}
    log("[kernel] timing mamba2_ssd by heads per block (bf16, full shape): "
        + json.dumps({k: round(v, 4) for k, v in t["heads_per_block_ms"].items()}))
    del flush
    return t, worst


# ---------------------------------------------------------------------------
# phases 3 and 4: serve the main path, then parity against the oracle
# ---------------------------------------------------------------------------


def counters():
    """The launch counters of every kernel, by name."""
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

    return {"paged_decode": paged_decode_attention.launches,
            "paged_decode_merge": paged_decode_attention.merge_launches,
            "flash_prefill": flash_prefill.launches,
            "rwkv6_scan": rwkv6_scan.launches, "mamba2_ssd": mamba2_ssd.launches,
            "rwkv6_scan_stages": rwkv6_scan.stage_launches,
            "mamba2_ssd_stages": mamba2_ssd.stage_launches}


def zero_counters() -> None:
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

    paged_decode_attention.launches = 0
    paged_decode_attention.merge_launches = 0
    flash_prefill.launches = 0
    rwkv6_scan.launches = 0
    mamba2_ssd.launches = 0
    rwkv6_scan.stage_launches = 0
    mamba2_ssd.stage_launches = 0


def engine_config(device_pages, host_pages, *, pipeline=False, tracing=False):
    from repro_torch.config import EngineConfig

    return EngineConfig(device_pool_pages=device_pages, host_pool_pages=host_pages,
                        policy="neo", pipeline=pipeline, hw_profile="h100_sxm", seed=0,
                        tracing=tracing)


def make_trace(n, vocab, seed=0, *, rate=0.0, output_len=32):
    """n requests, prompts uniform in [256, 768], all at t = 0 or, with a
    rate, at Poisson arrival times."""
    import numpy as np

    from repro_torch.serving.traces import TraceRequest, poisson_arrivals

    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate, rng)
    trace = [TraceRequest(float(t), int(rng.integers(256, 769)), output_len)
             for t in arrivals]
    for t in trace:
        t.materialise(rng, vocab)
    return trace


def residency_of(r, host):
    """Where a prefilled row's prefix came from: cold, a device hit, an
    in-place host hit, promoted to the device, or demoted to the host with
    its row."""
    if r.cached_len == 0:
        return "cold"
    if host:
        return "in-place host hit" if r.prefix_loc == "cpu" else "demoted with its row"
    return "promoted" if r.prefix_loc == "cpu" else "device hit"


def drive(engine, trace, runner):
    """Run ``trace`` through ``runner`` with every launch counter zeroed just
    before and read just after, counting the executor's calls: the serial /
    batch-0 decode passes (each launches the paged decode kernel once per
    layer), the host lanes (no kernel) and the prefills, with those that
    have a cold row (each launches the flash prefill kernel once per layer;
    prefix-cache hits prefill their suffix in plain attention, as the
    reference does).  Also returns each prefill's (B, padded S) and the
    residency of each prefilled row's prefix, keyed by prompt."""
    from repro_torch.core.executor import _bucket

    ex = engine.executor
    calls = {"decode": 0, "decode_batch0": 0, "prefill": 0, "prefill_with_cold_row": 0}
    shapes, residency = [], {}

    def counted(name):
        fn = getattr(ex, name)

        def wrapped(*a, **k):
            calls[name] += 1
            if name == "prefill":
                reqs, to_host = a[0], a[1]
                # the padded batch the cold prefill hands K2 (the reference's bucket)
                shapes.append((len(reqs), _bucket(max(r.prefill_len for r in reqs), 16)))
                calls["prefill_with_cold_row"] += any(r.cached_len == 0 for r in reqs)
                for r, host in zip(reqs, to_host):
                    residency[tuple(r.prompt)] = residency_of(r, host)
            return fn(*a, **k)
        return wrapped

    for name in ("decode", "decode_batch0", "prefill"):
        setattr(ex, name, counted(name))
    zero_counters()
    metrics = runner(engine, trace)
    launched = counters()
    return metrics, launched, calls, shapes, residency


def check_paged_launches(cfg, launched, calls, label):
    """paged_decode = layers x decode passes, flash_prefill = layers x
    prefills with a cold row (every prefill without the prefix cache), no
    scan kernel; the merge kernel follows some attention launches (the rows
    are long enough to split)."""
    L = cfg.num_layers
    passes = calls["decode"] + calls["decode_batch0"]
    want = {"paged_decode": L * passes, "flash_prefill": L * calls["prefill_with_cold_row"],
            "rwkv6_scan": 0, "mamba2_ssd": 0}
    got = {k: launched[k] for k in want}
    if got != want or passes == 0 or calls["prefill_with_cold_row"] == 0:
        raise AssertionError(f"{label}: launches {got} != {want} ({L} layers x {calls})")
    if not 0 < launched["paged_decode_merge"] <= launched["paged_decode"]:
        raise AssertionError(f"{label}: merge kernel launches {launched['paged_decode_merge']} "
                             f"not in (0, {launched['paged_decode']}]")


def serve_phase(cfg, device, *, n=8, device_pages=64, host_pages=512, pipeline=False,
                tracing=False):
    """Serve ``n`` requests through the paged path (serial, or pipelined;
    traced or not) with ``run_trace``; returns (engine, trace, metrics,
    launches, calls, prefill shapes)."""
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.request import RequestState
    from repro_torch.launch.serve import run_trace

    engine = NeoEngine(cfg, engine_config(device_pages, host_pages, pipeline=pipeline,
                                          tracing=tracing), device=device)
    trace = make_trace(n, cfg.vocab_size)
    label = ("traced " if tracing else "") + ("pipelined" if pipeline else "serial")
    m, launched, calls, shapes, _ = drive(
        engine, trace, lambda e, t: run_trace(e, t, vocab=cfg.vocab_size))
    engine.close()
    check_paged_launches(cfg, launched, calls, label)
    done = [r for r in engine.requests.values() if r.state == RequestState.FINISHED]
    if len(done) != n:
        raise AssertionError(f"{label}: only {len(done)}/{n} requests finished")
    s = engine.stats
    if not (s.offloaded_decodes > 0 and s.device_decodes > 0 and engine.pool.swap_bytes > 0):
        raise AssertionError(f"{label}: main path did not split: offloaded="
                             f"{s.offloaded_decodes} device={s.device_decodes} "
                             f"swap_bytes={engine.pool.swap_bytes}")
    return engine, trace, m, launched, calls, shapes


def serve_summary(cfg, engine, m, launched, calls, card):
    s = engine.stats
    return {
        "model": cfg.name, "dtype": cfg.activation_dtype, "layers": cfg.num_layers,
        "pipeline": engine.engine_cfg.pipeline, "requests": len(m.finished),
        "output_tok_s": m.throughput, "total_tok_s": m.token_throughput,
        "ttft_s": m.ttft(), "tpot_s": m.tpot(), "makespan_s": m.makespan,
        "iterations": s.iterations, "offloaded_decodes": s.offloaded_decodes,
        "device_decodes": s.device_decodes, "swap_bytes": engine.pool.swap_bytes,
        "executor_calls": calls, "kernel_launches": launched, "modes": s.mode_counts,
        "host_attention_busy_s": s.host_busy_time, "device_busy_s": s.device_busy_time,
        "plan_busy_s": s.plan_busy_time, "lane_busy_s": s.lane_busy_time,
        "overlap_s": s.pipeline_overlap_time, "ideal_overlap_s": s.pipeline_ideal_time,
        "bubble_fraction": s.bubble_fraction, "pipelined_steps": s.pipelined_steps,
        "borrowed_lane_steps": s.borrowed_lane_steps,
        "microbatched_steps": s.microbatched_steps, "serial_b1_steps": s.serial_b1_steps,
        "lane_counts": {str(k): v for k, v in sorted(s.lane_counts.items())},
        "swap_out_MB": s.swap_out_bytes / 1e6, "swap_in_MB": s.swap_in_bytes / 1e6,
        "swap_hidden_MB": s.swap_hidden_bytes / 1e6, "swap_wait_s": s.swap_wait_time,
        "planahead_hits": s.planahead_hits, "planahead_replans": s.planahead_replans,
        "planahead_skipped": s.planahead_skipped,
        "planahead_hidden_s": s.planahead_hidden_time, "card": card,
    }


def pipelined_phase(cfg, device, serial_engine, card):
    """The serial phase's trace and pools through the pipelined engine
    (async swaps, host lanes, plan-ahead, micro-batching); its tokens must
    equal the serial phase's bitwise (the reference's claim, which the
    executor's row buckets and the paged decode kernel's per-row page
    ranges make hold in bf16)."""
    engine, trace, m, launched, calls, _ = serve_phase(cfg, device, pipeline=True)
    s = engine.stats
    if s.pipelined_steps <= 0:
        raise AssertionError(f"pipelined phase: no pipelined step ({s.mode_counts})")
    if s.swap_out_bytes + s.swap_in_bytes <= 0:
        raise AssertionError("pipelined phase: no swap went through the TransferEngine")
    if s.planahead_hits <= 0:
        raise AssertionError("pipelined phase: plan-ahead never adopted a plan")
    same = total = 0
    for rid, req in engine.requests.items():
        ser = serial_engine.requests[rid].out_tokens
        total += len(req.out_tokens)
        same += sum(a == b for a, b in zip(req.out_tokens, ser))
    summary = serve_summary(cfg, engine, m, launched, calls, card)
    summary.update(tokens_equal_to_serial=same, tokens=total)
    if same != total or total == 0:
        raise AssertionError(f"pipelined phase: {same} of {total} bf16 tokens equal the "
                             "serial phase's")
    return engine, summary


def online_phase(cfg, device, card, *, n=8, rate=4.0):
    """A short open-loop run: ``run_online`` with Poisson arrivals on the
    pipelined engine; every request finishes and plan-ahead adopts plans."""
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.request import RequestState
    from repro_torch.launch.serve import run_online

    engine = NeoEngine(cfg, engine_config(64, 512, pipeline=True), device=device)
    trace = make_trace(n, cfg.vocab_size, seed=1, rate=rate, output_len=16)
    streamed = {}
    m, launched, calls, _, _ = drive(engine, trace, lambda e, t: run_online(
        e, t, vocab=cfg.vocab_size, on_token=lambda rid, tok: streamed.setdefault(
            rid, []).append(tok)))
    engine.close()
    check_paged_launches(cfg, launched, calls, "open loop")
    done = [r for r in engine.requests.values() if r.state == RequestState.FINISHED]
    if len(done) != n or len(m.finished) != n:
        raise AssertionError(f"open loop: only {len(done)}/{n} requests finished")
    if streamed != {rid: list(r.out_tokens) for rid, r in engine.requests.items()}:
        raise AssertionError("open loop: streamed tokens differ from the final tokens")
    if engine.stats.planahead_hits <= 0:
        raise AssertionError("open loop: plan-ahead never adopted a plan")
    summary = serve_summary(cfg, engine, m, launched, calls, card)
    summary.update(arrivals="poisson", rate_rps=rate,
                   last_arrival_s=max(t.arrival_time for t in trace),
                   ttft_p99_s=m.ttft(99), tpot_p99_s=m.tpot(99))
    del engine
    return summary


def check_traced(label, tracer, stats, tokens, want_tokens):
    """A traced run's tokens equal the untraced run's bitwise, no event was
    dropped and ``obs.reconcile`` of its spans agrees with its EngineStats;
    returns (tokens equal, tokens, the reconcile report)."""
    from repro_torch.obs import reconcile

    same = sum(a == b for rid, toks in tokens.items()
               for a, b in zip(toks, want_tokens[rid]))
    total = sum(len(t) for t in want_tokens.values())
    if same != total or total == 0 or tokens.keys() != want_tokens.keys():
        raise AssertionError(f"{label}: {same} of {total} traced tokens equal the untraced "
                             "run's")
    if tracer.dropped:
        raise AssertionError(f"{label}: the tracer's ring dropped {tracer.dropped} events")
    rep = reconcile(tracer, stats)
    if not rep.ok:
        raise AssertionError(f"{label}: reconcile failed {rep.failed()}: "
                             + json.dumps(rep.summary()))
    return same, total, rep


def traced_phase(cfg, device, want_tokens, untraced_makespan, card):
    """The pipelined phase's trace, pools and weights with engine tracing
    on: its tokens must equal the untraced phase's, ``reconcile`` must pass,
    and the exported Chrome trace must pass ``obs.validate`` with a host
    lane, a copy stream and at least one adopted plan."""
    from repro_torch.obs.validate import validate

    engine, _, m, launched, calls, _ = serve_phase(cfg, device, pipeline=True, tracing=True)
    tr = engine.tracer
    tokens = {rid: list(r.out_tokens) for rid, r in engine.requests.items()}
    same, total, rep = check_traced("traced pipelined phase", tr, engine.stats, tokens,
                                    want_tokens)
    path = os.path.join(ROOT, "build", "chip_smoke_trace_qwen3.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = tr.export_chrome(path)
    fails = validate(path, expect_host_lane=True, expect_copy=True, min_adopts=1)
    if fails:
        raise AssertionError(f"traced pipelined phase: obs.validate failed: {fails}")
    summary = serve_summary(cfg, engine, m, launched, calls, card)
    summary.update(traced=True, tokens_equal_to_untraced=same, tokens=total,
                   events_recorded=tr.total, events_dropped=tr.dropped,
                   chrome_events=len(doc["traceEvents"]), tracks=tr.tracks(),
                   makespan_ratio_traced_untraced=m.makespan / untraced_makespan,
                   reconcile_checks=len(rep.checks), reconcile_ok=rep.ok,
                   reconcile={k: v for k, v in rep.checks.items()
                              if not k.startswith("lane_busy")})
    return summary


def busy_share_phase(torch, cfg, device, card, *, steps=8):
    """The card's busy share over ``steps`` decode steps after prefill of an
    untraced pipelined qwen3-0.6b run (the serve phases' trace and pools):
    the union of the kernels' device intervals (torch.profiler, CUDA
    activity) over the window's wall time, the copies' union apart, and the
    five kernels with the most total time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import NeoEngine

    engine = NeoEngine(cfg, engine_config(64, 512, pipeline=True), device=device)
    for t in make_trace(8, cfg.vocab_size):
        engine.submit(t.prompt, t.output_len)
    while any(not r.out_tokens for r in engine.requests.values()):
        engine.step()
    torch.cuda.synchronize()
    tokens0 = engine.stats.tokens_out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = engine.stats
    engine.close()
    kernels, copies, by_name = [], [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if e.name.startswith(("Memcpy", "Memset")):
            copies.append(iv)
        else:
            kernels.append(iv)
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (iv[1] - iv[0]) / 1e3)
    if not kernels:
        raise AssertionError("busy share: the profiler recorded no kernel on the card")

    def union_s(ivs):
        total, end = 0.0, -math.inf
        for a, b in sorted(ivs):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e6

    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return {"model": cfg.name, "dtype": cfg.activation_dtype, "pipeline": True,
            "window_steps": steps, "window_wall_s": wall,
            "window_tokens": s.tokens_out - tokens0,
            "kernel_busy_s": union_s(kernels), "busy_share": union_s(kernels) / wall,
            "idle_share": 1.0 - union_s(kernels) / wall,
            "copy_busy_share": union_s(copies) / wall if copies else 0.0,
            "kernels_recorded": len(kernels), "kernel_names": len(by_name),
            "kernel_sum_ms": sum(t for _, t in by_name.values()),
            "top5_kernels": [{"name": k[:120], "launches": n, "total_ms": t}
                             for k, (n, t) in top],
            "card": card}


def dense_oracle_parity(torch, model, runs, chunk=8, patches=None):
    """Every token of ``runs`` [(rid, prompt, emitted tokens)] must be the
    oracle's argmax or within NEAR_TIE of its max logit; the oracle is
    ``model``'s plain contiguous prefill over prompt + out[:i] (rows of one
    request batched with true_lens; a vlm request's ``patches[rid]`` in each
    row), with the plain attention, never the flash prefill kernel.
    Returns the counts."""
    exact = ties = total = 0
    worst_gap = 0.0
    for rid, prompt, out in runs:
        pe = None if patches is None else torch.as_tensor(patches[rid])
        seqs = [prompt + out[:i] for i in range(len(out))]
        for c0 in range(0, len(seqs), chunk):
            rows = seqs[c0:c0 + chunk]
            S = max(map(len, rows))
            tok = torch.zeros(len(rows), S, dtype=torch.long)
            for j, r in enumerate(rows):
                tok[j, : len(r)] = torch.tensor(r)
            lens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
            kw = {} if pe is None else {"patch_embeds": pe[None].expand(len(rows), *pe.shape)}
            logits, _ = model.prefill(tok, true_lens=lens, impl="plain", **kw)
            for j in range(len(rows)):
                want = int(logits[j].argmax())
                got = out[c0 + j]
                gap = float(logits[j, want] - logits[j, got])
                total += 1
                if got == want:
                    exact += 1
                elif gap <= NEAR_TIE:
                    ties += 1
                    worst_gap = max(worst_gap, gap)
                else:
                    raise AssertionError(
                        f"parity: rid {rid} token {c0 + j}: engine {got}, oracle {want}, "
                        f"logit gap {gap:.3e} > {NEAR_TIE}")
    return dict(tokens=total, exact=exact, near_ties=ties, worst_tie_gap=worst_gap)


def parity_phase(torch, cfg, device, trace, *, device_pages=64, host_pages=512, chunk=8,
                 pipeline=False):
    """fp32 engine on the same prompts, every emitted token held to the
    dense oracle (:func:`dense_oracle_parity`, the engine's own DenseLM).
    The pipelined engine must put host rows in batch-1 lanes."""
    from repro_torch.core.engine import NeoEngine

    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    engine = NeoEngine(cfg32, engine_config(device_pages, host_pages, pipeline=pipeline),
                       device=device)
    rids = [engine.submit(t.prompt, t.output_len) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    s = engine.stats
    if pipeline and not (s.pipelined_steps > 0 and sum(s.lane_counts.values()) > 0):
        raise AssertionError(f"pipelined parity: no host rows in batch-1 lanes "
                             f"(lane_counts {s.lane_counts}, {s.pipelined_steps} steps)")
    for rid, t in zip(rids, trace):
        if len(outs[rid]) != t.output_len:
            raise AssertionError(f"parity engine: rid {rid} emitted {len(outs[rid])} tokens")
    counts = dense_oracle_parity(torch, engine.model,
                                 [(rid, t.prompt, outs[rid]) for rid, t in zip(rids, trace)],
                                 chunk)
    return dict(model=cfg.name, pipeline=pipeline, **counts,
                offloaded_decodes=s.offloaded_decodes, device_decodes=s.device_decodes,
                pipelined_steps=s.pipelined_steps,
                lane_counts={str(k): v for k, v in sorted(s.lane_counts.items())})


# ---------------------------------------------------------------------------
# the prefix cache: two-tier radix tree, zero-copy host serving
# ---------------------------------------------------------------------------

# the reference prefix-cache benchmark's prefill-heavy multiturn shape
# (benchmarks/prefix_cache.py:39-45): long shared histories, short answers
PREFIX_SHAPE = dict(system_len=384, context_len=96, user_len_median=64, output_median=10,
                    max_output=16)
PREFIX_REQUESTS, PREFIX_TURNS = 12, 4
# device and host pages (16 tokens each): at the serve phases' 64 device
# pages every hit but one is served from the host; at 80 one conversation's
# history stays on the card, so device hits, in-place host hits, promotions
# and demotions all occur (the schedule does not depend on the tokens: no
# eos, and prompts carry no outputs)
PREFIX_POOLS = (80, 512)


def prefix_trace(vocab):
    """12 requests, 3 conversations of 4 turns, every prompt opening with one
    384-token system prompt."""
    from repro_torch.serving.traces import multiturn_trace

    return multiturn_trace(PREFIX_REQUESTS, rate=1e9, seed=0, turns=PREFIX_TURNS,
                           vocab=min(vocab, 500), **PREFIX_SHAPE)


def prefix_run(cfg, device, *, cache, tracing=False):
    """The multiturn conversations through ``run_conversations`` (a turn goes
    in when its conversation's last one finished) on the pipelined engine
    with the perf model frozen (``ewma_alpha=0``: the plans follow from the
    inputs alone, the same in every run of a dtype), counted by
    :func:`drive`.  Returns (engine, metrics, launches, calls, residency by
    prompt)."""
    from repro_torch.config import EngineConfig
    from repro_torch.core.engine import NeoEngine
    from repro_torch.launch.serve import run_conversations

    ecfg = EngineConfig(device_pool_pages=PREFIX_POOLS[0], host_pool_pages=PREFIX_POOLS[1],
                        policy="neo", pipeline=True, hw_profile="h100_sxm", seed=0,
                        ewma_alpha=0.0, prefix_cache=cache, tracing=tracing)
    engine = NeoEngine(cfg, ecfg, device=device)
    m, launched, calls, _, residency = drive(engine, prefix_trace(cfg.vocab_size),
                                             run_conversations)
    engine.close()
    done = [r for r in engine.requests.values() if r.state.name == "FINISHED"]
    if len(done) != PREFIX_REQUESTS:
        raise AssertionError(f"prefix phase: only {len(done)}/{PREFIX_REQUESTS} finished")
    return engine, m, launched, calls, residency


def free_card(torch):
    """Collect the engine just dropped (the counting wrappers keep its
    executor in a cycle) and give its memory back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def prefix_summary(engine, m, launched, calls, residency, card):
    s = engine.stats
    out = {"model": engine.cfg.name, "dtype": engine.cfg.activation_dtype,
           "prefix_cache": engine.prefix_cache is not None,
           "pools_pages": {"device": PREFIX_POOLS[0], "host": PREFIX_POOLS[1]},
           "requests": len(m.finished), "prompt_tokens": sum(r.prompt_len for r in m.finished),
           "prefill_tokens_computed": s.prefill_tokens, "makespan_s": m.makespan,
           "ttft_s": m.ttft(), "tpot_s": m.tpot(), "iterations": s.iterations,
           "executor_calls": calls, "kernel_launches": launched,
           "lane_busy_s": s.lane_busy_time, "host_attention_busy_s": s.host_busy_time,
           "host_prefix_busy_s": engine.host_attn.prefix_busy_time,
           "host_prefix_bytes_read": engine.host_attn.prefix_bytes_read,
           "swap_bytes": engine.pool.swap_bytes, "planahead_hits": s.planahead_hits,
           "planahead_replans": s.planahead_replans, "planahead_skipped": s.planahead_skipped,
           "residency": dict(collections.Counter(residency.values())), "card": card}
    if engine.prefix_cache is not None:
        out["prefix_stats"] = dataclasses.asdict(engine.prefix_cache.stats)
        out["hit_rate"] = engine.prefix_cache.stats.hit_rate
    return out


def ttft_by_prompt(engine, m):
    """Each turn's TTFT (from its submission), keyed by its prompt."""
    return {tuple(engine.requests[r.rid].prompt): r.ttft for r in m.records}


def ttft_split(ttft_on, ttft_off, residency_on):
    """Mean TTFT of the turns the cache served and of the cold ones, with
    the cache on, and of the same turns with it off."""
    mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
    out = {}
    for kind in ("hit", "cold"):
        turns = [p for p, where in residency_on.items() if (where == "cold") == (kind == "cold")]
        out[kind] = {"turns": len(turns), "cache_on_s": mean([ttft_on[p] for p in turns]),
                     "cache_off_s": mean([ttft_off[p] for p in turns])}
    return out


def prefix_phase(torch, cfg, card):
    """Full-width qwen3-0.6b on the pipelined engine over the multiturn
    conversations: (a) bf16 with the cache off; (b) bf16 with the cache on,
    traced: device hits, in-place host hits, copy-on-write pages and
    demotions each > 0, prefill tokens at most half of (a)'s, the launch
    counts of K1 and K2, reconcile() ok with nothing dropped, obs.validate
    ok on the export with host-prefix and copy-sync spans; the tokens equal
    to (a)'s are counted, and each request that differs is printed with the
    residency of its prefix; (c) fp32 with the cache on, every token held
    to the dense oracle (and counted against an fp32 cache-off run)."""
    from repro_torch.obs import reconcile
    from repro_torch.obs.validate import validate

    log(f"[prefix] pools: device {PREFIX_POOLS[0]} pages, host {PREFIX_POOLS[1]} pages of "
        f"{cfg.kv_block_size} tokens; {PREFIX_REQUESTS} requests in "
        f"{PREFIX_REQUESTS // PREFIX_TURNS} conversations of {PREFIX_TURNS} turns, shape "
        + json.dumps(PREFIX_SHAPE))
    off, m_a, l_a, c_a, r_a = prefix_run(cfg, "cuda", cache=False)
    check_paged_launches(cfg, l_a, c_a, "prefix phase (a)")
    sum_a = prefix_summary(off, m_a, l_a, c_a, r_a, card)
    log(json.dumps({"prefix": {"run": "a: bf16, cache off", **sum_a}}))
    # runs are compared turn by turn, keyed by the prompt (every turn's is
    # its own): the rids follow the order in which turns finish
    tokens_a = {tuple(r.prompt): list(r.out_tokens) for r in off.requests.values()}
    ttft_a = ttft_by_prompt(off, m_a)
    del off
    free_card(torch)

    on, m_b, l_b, c_b, r_b = prefix_run(cfg, "cuda", cache=True, tracing=True)
    check_paged_launches(cfg, l_b, c_b, "prefix phase (b)")
    st = on.prefix_cache.stats
    where = collections.Counter(r_b.values())
    need = {"device hits": where["device hit"], "in-place host hits": st.inplace_host_hits,
            "cow copies": st.cow_copies, "demoted pages": st.demoted_pages}
    if min(need.values()) <= 0:
        raise AssertionError(f"prefix phase (b): a counter is 0: {need}, residency {where}")
    if 2 * on.stats.prefill_tokens > sum_a["prefill_tokens_computed"]:
        raise AssertionError(f"prefix phase (b): {on.stats.prefill_tokens} prefill tokens "
                             f"computed, more than half of (a)'s "
                             f"{sum_a['prefill_tokens_computed']}")
    tr = on.tracer
    rep = reconcile(tr, on.stats)
    if tr.dropped or not rep.ok:
        raise AssertionError(f"prefix phase (b): dropped {tr.dropped}, reconcile "
                             f"{rep.failed()}: " + json.dumps(rep.summary()))
    tracks = collections.Counter(e.track for e in tr.events() if e.ph == "X")
    if tracks["hostattn-prefix"] <= 0 or tracks["copy-sync"] <= 0 or tracks["prefix"] <= 0:
        raise AssertionError(f"prefix phase (b): spans by track {dict(tracks)}")
    path = os.path.join(ROOT, "build", "chip_smoke_trace_prefix.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tr.export_chrome(path)
    fails = validate(path, expect_copy=True)
    if fails:
        raise AssertionError(f"prefix phase (b): obs.validate failed: {fails}")
    same = total = 0
    differs = {}
    for rid, r in on.requests.items():
        want = tokens_a[tuple(r.prompt)]
        total += len(want)
        same += sum(x == y for x, y in zip(r.out_tokens, want))
        if r.out_tokens != want:
            differs[rid] = {"residency": r_b[tuple(r.prompt)], "first_diff": next(
                (i for i, (x, y) in enumerate(zip(r.out_tokens, want)) if x != y),
                min(len(want), len(r.out_tokens))), "tokens": len(want)}
    sum_b = prefix_summary(on, m_b, l_b, c_b, r_b, card)
    sum_b.update(ttft_by_turn_kind_s=ttft_split(ttft_by_prompt(on, m_b), ttft_a, r_b),
                 tokens_equal_to_cache_off=same, tokens=total, differing_requests=differs,
                 events_recorded=tr.total, events_dropped=tr.dropped,
                 spans_by_track={k: tracks[k] for k in ("prefix", "copy-sync",
                                                         "hostattn-prefix")},
                 reconcile_ok=rep.ok, reconcile_checks=len(rep.checks),
                 prefill_token_ratio=on.stats.prefill_tokens
                 / sum_a["prefill_tokens_computed"])
    log(json.dumps({"prefix": {"run": "b: bf16, cache on, traced", **sum_b}}))
    split = sum_b["ttft_by_turn_kind_s"]
    log(f"[prefix] TTFT of the {split['hit']['turns']} hit turns {split['hit']['cache_on_s']:.4f} s "
        f"(the same turns with the cache off {split['hit']['cache_off_s']:.4f} s), of the "
        f"{split['cold']['turns']} cold turns {split['cold']['cache_on_s']:.4f} s; prefill lane "
        f"{on.stats.lane_busy_time.get('prefill', 0.0):.4f} s (cache off "
        f"{sum_a['lane_busy_s'].get('prefill', 0.0):.4f} s), host-prefix partials "
        f"{on.host_attn.prefix_busy_time:.4f} s")
    log(f"[prefix] bf16 cache on vs off: {same} of {total} tokens equal; "
        f"{len(differs)} requests differ: "
        + "; ".join(f"rid {rid} ({d['residency']}, first at token {d['first_diff']})"
                    for rid, d in sorted(differs.items())))
    del on, tr
    free_card(torch)

    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    on32, _, _, _, r_c = prefix_run(cfg32, "cuda", cache=True)
    runs = [(rid, r.prompt, list(r.out_tokens)) for rid, r in sorted(on32.requests.items())]
    tokens32 = {tuple(prompt): out for _, prompt, out in runs}
    parity = dense_oracle_parity(torch, on32.model, runs)
    st32 = on32.prefix_cache.stats
    del on32
    free_card(torch)
    off32, *_ = prefix_run(cfg32, "cuda", cache=False)
    same32 = sum(x == y for r in off32.requests.values()
                 for x, y in zip(r.out_tokens, tokens32[tuple(r.prompt)]))
    del off32
    free_card(torch)
    sum_c = {"run": "c: fp32, cache on", "parity": parity, "hits": st32.hits,
             "inplace_host_hits": st32.inplace_host_hits, "cow_copies": st32.cow_copies,
             "demoted_pages": st32.demoted_pages,
             "residency": dict(collections.Counter(r_c.values())),
             "tokens_equal_to_fp32_cache_off": same32, "tokens": parity["tokens"],
             "card": card}
    log(json.dumps({"prefix": sum_c}))
    return sum_a, sum_b, sum_c


# ---------------------------------------------------------------------------
# phase 3d: speculative decoding (draft -> one batched verify pass -> accept)
# ---------------------------------------------------------------------------

SPEC_K = 4  # EngineConfig.spec_k: drafts per row and step at most
SPEC_REQUESTS, SPEC_OUTPUT = 8, 32


def spec_trace(vocab, seed=5):
    """8 repetition-heavy requests at t = 0: one 64-token base repeated 4
    times, then a tail uniform in [32, 128] (the reference test's
    construction, at full width), 32 outputs each."""
    import numpy as np

    from repro_torch.serving.traces import TraceRequest

    rng = np.random.default_rng(seed)
    base = list(map(int, rng.integers(1, vocab, 64)))
    trace = []
    for _ in range(SPEC_REQUESTS):
        tail = list(map(int, rng.integers(1, vocab, int(rng.integers(32, 129)))))
        prompt = base * 4 + tail
        trace.append(TraceRequest(0.0, len(prompt), SPEC_OUTPUT, prompt=prompt))
    return trace


# the replay drafter: proposes the recorded continuation of a run with
# speculation off, so every draft is accepted (forced full accepts at depth K)
ReplayDrafter = OracleDrafter


class WrongDrafter(ReplayDrafter):
    """Proposes one token that differs from the recorded next token: every
    draft is rejected (forced rollback on every verify pass)."""

    def __init__(self, prompts, outs, vocab):
        super().__init__(prompts, outs)
        self.vocab = vocab

    def propose(self, tokens, k):
        cont = super().propose(tokens, k)
        return [(cont[0] + 1) % self.vocab] if cont else []


def spec_run(cfg, trace, *, device_pages, host_pages, spec, drafter=None, label="",
             all_merge=True):
    """The trace through ``launch.serve.run_trace`` on the pipelined paged
    engine, counted by :func:`drive`; the verify passes are counted apart
    (the calls of the executor's decode made inside the chain), with their
    largest row count, and each request's residency at each emitted token
    is logged.  ``all_merge``: every K1 launch is followed by a merge (no
    pass of host rows only).  Returns (engine, metrics, launches, calls,
    spec record)."""
    from repro_torch.config import EngineConfig
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.executor import _bucket
    from repro_torch.launch.serve import run_trace

    ecfg = EngineConfig(device_pool_pages=device_pages, host_pool_pages=host_pages,
                        policy="neo", pipeline=True, hw_profile="h100_sxm", seed=0,
                        spec_decode=spec, spec_k=SPEC_K)
    engine = NeoEngine(cfg, ecfg, device="cuda")
    if drafter is not None:
        engine.drafter = drafter
    rec = {"verify_passes": 0, "max_pseudo_rows": 0, "host_pseudo_row_passes": 0,
           "residency": collections.defaultdict(list)}
    ex, in_chain = engine.executor, [False]
    decode, chain, step = ex.decode, engine._run_spec_chain, engine._step

    def counted_decode(rows, flags):
        if in_chain[0]:
            rec["verify_passes"] += 1
            rec["max_pseudo_rows"] = max(rec["max_pseudo_rows"], len(rows))
            rec["host_pseudo_row_passes"] += any(flags)
        return decode(rows, flags)

    def counted_chain(*a):
        in_chain[0] = True
        try:
            return chain(*a)
        finally:
            in_chain[0] = False

    def located_step(now):
        emitted = step(now)
        for rid, _ in emitted:
            rec["residency"][rid].append(engine.requests[rid].location)
        return emitted

    ex.decode, engine._run_spec_chain, engine._step = counted_decode, counted_chain, located_step
    m, launched, calls, _, _ = drive(engine, trace, lambda e, t: run_trace(
        e, t, vocab=cfg.vocab_size))
    engine.close()
    done = [r for r in engine.requests.values() if r.state.name == "FINISHED"]
    if len(done) != len(trace):
        raise AssertionError(f"spec phase {label}: only {len(done)}/{len(trace)} finished")
    s = engine.stats
    if rec["verify_passes"] != s.spec_steps:
        raise AssertionError(f"spec phase {label}: {rec['verify_passes']} verify passes, "
                             f"{s.spec_steps} spec steps")
    base = calls["decode"] + calls["decode_batch0"] - rec["verify_passes"]
    L = cfg.num_layers
    # K1 once per layer per decode and verify pass, each followed by a merge
    # (device rows of 9+ pages; a host-only pass launches no merge); K2 once
    # per layer per prefill call, the draft model's included
    draft_prefills = getattr(engine.drafter, "prefills", 0)
    draft_layers = engine.drafter.model.cfg.num_layers if draft_prefills else 0
    want = {"paged_decode": L * (base + s.spec_steps),
            "flash_prefill": L * calls["prefill_with_cold_row"] + draft_layers * draft_prefills,
            "rwkv6_scan": 0, "mamba2_ssd": 0}
    got = {k: launched[k] for k in want}
    merges = launched["paged_decode_merge"]
    if got != want or not (merges == want["paged_decode"] if all_merge
                           else 0 < merges <= want["paged_decode"]):
        raise AssertionError(f"spec phase {label}: launches {got} != {want}, merges {merges} "
                             f"({L} layers x ({base} decode passes + {s.spec_steps} verify "
                             f"passes), {L} x {calls['prefill_with_cold_row']} prefill calls, "
                             f"{draft_layers} x {draft_prefills} draft prefills)")
    if sum(k * v for k, v in s.accept_len_hist.items()) != s.accepted_tokens:
        raise AssertionError(f"spec phase {label}: histogram {s.accept_len_hist} does not "
                             f"sum to {s.accepted_tokens} accepted tokens")
    rec["max_verify_bucket"] = _bucket(rec["max_pseudo_rows"]) if rec["max_pseudo_rows"] else 0
    rec["base_decode_passes"] = base
    rec["pages_in_use"] = (engine.pool.device.used_pages, engine.pool.host.used_pages)
    return engine, m, launched, calls, rec


def spec_tokens(engine):
    return {rid: list(r.out_tokens) for rid, r in engine.requests.items()}


def spec_summary(engine, m, launched, rec, card, **extra):
    s = engine.stats
    return {"model": engine.cfg.name, "dtype": engine.cfg.activation_dtype,
            "spec": engine.drafter is not None,
            "drafter": type(engine.drafter).__name__ if engine.drafter is not None else None,
            "requests": len(m.finished), "makespan_s": m.makespan,
            "output_tok_s": m.throughput, "ttft_s": m.ttft(), "tpot_s": m.tpot(),
            "iterations": s.iterations, "spec_steps": s.spec_steps,
            "drafted": s.drafted_tokens, "accepted": s.accepted_tokens,
            "rejected": s.rejected_drafts,
            "accept_rate": s.accepted_tokens / s.drafted_tokens if s.drafted_tokens else None,
            "accept_len_hist": {str(k): v for k, v in sorted(s.accept_len_hist.items())},
            "spec_busy_s": s.spec_busy_time, "lane_busy_s": s.lane_busy_time,
            "offloaded_decodes": s.offloaded_decodes, "device_decodes": s.device_decodes,
            "verify_passes": rec["verify_passes"], "base_decode_passes": rec["base_decode_passes"],
            "max_pseudo_rows": rec["max_pseudo_rows"],
            "max_verify_bucket": rec["max_verify_bucket"],
            "host_pseudo_row_passes": rec["host_pseudo_row_passes"],
            "pages_in_use": rec["pages_in_use"], "kernel_launches": launched, "card": card,
            **extra}


def spec_phase_a(torch, cfg, card):
    """(a) Device-resident qwen3-0.6b, bf16, pipelined, pools 512/512: spec
    off, the n-gram drafter, a replay drafter (full accepts) and a wrong
    drafter (no accepts) give bitwise equal tokens; no row leaves the card;
    K1 = layers x (decode passes + verify passes), as many merges."""
    trace = spec_trace(cfg.vocab_size)
    prompts = [t.prompt for t in trace]
    runs = {}
    for name in ("off", "ngram", "replay", "wrong"):
        drafter = None
        if name in ("replay", "wrong"):
            outs = [runs["off"][0][rid] for rid in sorted(runs["off"][0])]
            drafter = (ReplayDrafter(prompts, outs) if name == "replay"
                       else WrongDrafter(prompts, outs, cfg.vocab_size))
        engine, m, launched, _, rec = spec_run(cfg, trace, device_pages=512, host_pages=512,
                                               spec=name != "off", drafter=drafter,
                                               label=f"(a) {name}")
        s = engine.stats
        where = {loc for locs in rec["residency"].values() for loc in locs}
        if where != {"gpu"} or s.offloaded_decodes or engine.pool.swap_bytes:
            raise AssertionError(f"spec phase (a) {name}: a row left the card ({where}, "
                                 f"offloaded {s.offloaded_decodes}, swap bytes "
                                 f"{engine.pool.swap_bytes})")
        runs[name] = (spec_tokens(engine), spec_summary(engine, m, launched, rec, card), rec)
        del engine
        free_card(torch)
    off_tokens, off_used = runs["off"][0], runs["off"][2]["pages_in_use"]
    for name, (tokens, summary, rec) in runs.items():
        same = sum(a == b for rid, t in tokens.items() for a, b in zip(t, off_tokens[rid]))
        total = sum(map(len, off_tokens.values()))
        summary.update(run=f"a: {name}", tokens_equal_to_spec_off=same, tokens=total)
        log(json.dumps({"spec": summary}))
        if tokens != off_tokens:
            raise AssertionError(f"spec phase (a) {name}: {same} of {total} bf16 tokens equal "
                                 "spec off's")
        if rec["pages_in_use"] != off_used:
            raise AssertionError(f"spec phase (a) {name}: pages in use {rec['pages_in_use']} "
                                 f"!= spec off's {off_used}")
        if name == "off":
            continue
        if not (summary["spec_steps"] > 0 and summary["drafted"] > 0):
            raise AssertionError(f"spec phase (a) {name}: nothing drafted ({summary})")
        if name == "ngram" and summary["accepted"] <= 0:
            raise AssertionError("spec phase (a) ngram: no draft accepted")
        if name == "replay" and summary["accepted"] != summary["drafted"]:
            raise AssertionError(f"spec phase (a) replay: {summary['accepted']} of "
                                 f"{summary['drafted']} drafts accepted")
        if name == "wrong" and summary["accepted"] != 0:
            raise AssertionError(f"spec phase (a) wrong: {summary['accepted']} accepted")
    return {name: run[1] for name, run in runs.items()}


def spec_phase_b(torch, cfg, card):
    """(b) The same prompts with pools 64/512, so neo offloads and verify
    passes carry host pseudo-rows: fp32 spec on, every token the dense
    oracle's argmax or a near-tie, and equal to fp32 spec off; bf16 spec on
    against spec off counted, each differing request printed with its
    residency (recorded, not asserted)."""
    trace = spec_trace(cfg.vocab_size)
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    out = {}
    for dt, c in (("float32", cfg32), ("bfloat16", cfg)):
        runs = {}
        for spec in (True, False):
            engine, m, launched, _, rec = spec_run(c, trace, device_pages=64, host_pages=512,
                                                   spec=spec, label=f"(b) {dt} spec={spec}",
                                                   all_merge=False)
            summary = spec_summary(engine, m, launched, rec, card, run=f"b: {dt}, spec "
                                   + ("on" if spec else "off"), pools_pages=[64, 512])
            tokens = spec_tokens(engine)
            if spec and dt == "float32":
                summary["parity"] = dense_oracle_parity(
                    torch, engine.model, [(rid, engine.requests[rid].prompt, toks)
                                          for rid, toks in sorted(tokens.items())])
            runs[spec] = (None, tokens, summary, rec)
            del engine
            free_card(torch)
        on, off = runs[True], runs[False]
        if on[3]["host_pseudo_row_passes"] <= 0 or on[2]["offloaded_decodes"] <= 0:
            raise AssertionError(f"spec phase (b) {dt}: no verify pass carried a host "
                                 f"pseudo-row ({on[2]})")
        same = sum(a == b for rid, t in on[1].items() for a, b in zip(t, off[1][rid]))
        total = sum(map(len, off[1].values()))
        differs = {}
        for rid, toks in on[1].items():
            if toks != off[1][rid]:
                first = next((i for i, (a, b) in enumerate(zip(toks, off[1][rid])) if a != b),
                             min(len(toks), len(off[1][rid])))
                differs[rid] = {"first_diff": first,
                                "residency_on": on[3]["residency"][rid],
                                "residency_off": off[3]["residency"][rid]}
        on[2].update(tokens_equal_to_spec_off=same, tokens=total, differing_requests=differs)
        log(json.dumps({"spec": off[2]}))
        log(json.dumps({"spec": on[2]}))
        log(f"[spec] (b) {dt} spec on vs off: {same} of {total} tokens equal; "
            f"{len(differs)} requests differ"
            + "".join(f"; rid {rid} from token {d['first_diff']}, residency on "
                      f"{''.join('h' if x == 'cpu' else 'd' for x in d['residency_on'])} off "
                      f"{''.join('h' if x == 'cpu' else 'd' for x in d['residency_off'])}"
                      for rid, d in sorted(differs.items())))
        if dt == "float32" and (same != total or on[3]["pages_in_use"] != off[3]["pages_in_use"]):
            raise AssertionError(f"spec phase (b) fp32: {same} of {total} tokens equal spec "
                                 f"off's; pages {on[3]['pages_in_use']} vs "
                                 f"{off[3]['pages_in_use']}")
        out[dt] = on[2]
    return out


SPEC_TARGET, SPEC_DRAFT = "qwen3-14b", "qwen3-0.6b"
SPEC_C_REQUESTS, SPEC_C_OUTPUT = 4, 16


def spec_phase_c(torch, card):
    """(c) The draft-model path, ``serve --arch qwen3-14b --draft-model
    qwen3-0.6b --spec-decode``, both at full width (bf16, weights from
    seeded CUDA generators), pools that keep the rows on the card: tokens
    equal spec off's bitwise, drafts proposed, K2 = 28 x draft prefills +
    40 x target prefill calls; the accept rate (random weights) is printed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import draft_model_drafter
    from repro_torch.serving.traces import TraceRequest

    cfg = get_config(SPEC_TARGET)
    rng = np.random.default_rng(6)
    trace = []
    for _ in range(SPEC_C_REQUESTS):
        n = int(rng.integers(256, 513))
        trace.append(TraceRequest(0.0, n, SPEC_C_OUTPUT,
                                  prompt=list(map(int, rng.integers(1, cfg.vocab_size, n)))))
    runs = {}
    for spec in (False, True):
        torch.cuda.reset_peak_memory_stats()
        drafter = (draft_model_drafter(cfg, SPEC_DRAFT, smoke=False, seed=0, device="cuda")
                   if spec else None)
        engine, m, launched, calls, rec = spec_run(cfg, trace, device_pages=256, host_pages=64,
                                                   spec=spec, drafter=drafter,
                                                   label=f"(c) spec={spec}")
        prefills = drafter.prefills if drafter is not None else 0
        summary = spec_summary(engine, m, launched, rec, card,
                               run=f"c: {SPEC_TARGET}" + (f" + draft {SPEC_DRAFT}" if spec
                                                          else ", spec off"),
                               draft_prefills=prefills,
                               target_prefill_calls=calls["prefill_with_cold_row"],
                               peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
        runs[spec] = (spec_tokens(engine), summary)
        del engine, drafter
        free_card(torch)
    on, off = runs[True], runs[False]
    same = sum(a == b for rid, t in on[0].items() for a, b in zip(t, off[0][rid]))
    total = sum(map(len, off[0].values()))
    on[1].update(tokens_equal_to_spec_off=same, tokens=total)
    log(json.dumps({"spec": off[1]}))
    log(json.dumps({"spec": on[1]}))
    if on[0] != off[0]:
        raise AssertionError(f"spec phase (c): {same} of {total} bf16 tokens equal spec off's")
    if on[1]["drafted"] <= 0:
        raise AssertionError("spec phase (c): the draft model proposed nothing")
    return on[1], off[1]


def spec_phase(torch, card):
    """Phase 3d: (a), (b) on full-width qwen3-0.6b, then (c)."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    a = spec_phase_a(torch, cfg, card)
    b = spec_phase_b(torch, cfg.replace(num_layers=HOST_PHASE_LAYERS), card)
    c_on, c_off = spec_phase_c(torch, card)
    log(f"[spec] (a) bf16 device-resident: off / ngram / replay / wrong bitwise equal "
        f"(asserted); ngram accept rate {a['ngram']['accept_rate']:.4f}, largest verify "
        f"bucket {a['ngram']['max_verify_bucket']}; makespan off {a['off']['makespan_s']:.3f} s, "
        f"ngram {a['ngram']['makespan_s']:.3f} s; (c) {SPEC_TARGET} + {SPEC_DRAFT}: tokens "
        f"equal (asserted), accept rate {c_on['accept_rate']}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return a, b, c_on, c_off


# ---------------------------------------------------------------------------
# phases 3e and 3f: moe, vlm and the int8 cache; the encoder-decoder
# ---------------------------------------------------------------------------

MOE_ARCH, VLM_ARCH, AUDIO_ARCH = "deepseek-moe-16b", "internvl2-1b", "seamless-m4t-medium"
P11_OUT = 16  # outputs per request in 3e and 3f
MOE_FP32_LAYERS = 6  # dense0 + 5 moe layers at full width: ~13.8 GB in fp32
AUDIO_FRAMES = 1024


def p11_trace(vocab, seed, lo, hi, *, image=0):
    """8 requests at t = 0, prompts of lo..hi tokens (after ``image``
    placeholder positions, which a vlm's patches replace), P11_OUT outputs."""
    import numpy as np

    from repro_torch.serving.traces import TraceRequest

    rng = np.random.default_rng(seed)
    trace = [TraceRequest(0.0, image + int(rng.integers(lo, hi + 1)), P11_OUT)
             for _ in range(8)]
    for t in trace:
        t.materialise(rng, vocab)
    return trace


def seeded_extras(trace, key, shape, seed, scale=1.0):
    """{id(trace request): {key: seeded float32 array of ``shape``}} and the
    ``extras_fn`` of ``launch.serve.run_trace`` that hands them out."""
    import numpy as np

    rng = np.random.default_rng(seed)
    table = {id(t): {key: (rng.standard_normal(shape, dtype=np.float32) * scale)}
             for t in trace}
    return table, lambda tr: table[id(tr)]


def paged_serve(torch, cfg, trace, card, *, pipeline, extras_fn=None, label=""):
    """The trace through ``launch.serve.run_trace`` on the paged engine
    (pools 64/512: the neo policy must offload; the perf model frozen, so
    the serial and pipelined runs plan alike and each row decodes where it
    decodes in the other), counted by :func:`drive`; K1 = layers x decode
    passes, K2 = layers x prefill calls.  Returns (tokens by rid, summary,
    each rid's residency at each emitted token)."""
    from repro_torch.core.engine import NeoEngine
    from repro_torch.launch.serve import run_trace

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = NeoEngine(cfg, dataclasses.replace(engine_config(64, 512, pipeline=pipeline),
                                                ewma_alpha=0.0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    residency, step = collections.defaultdict(str), engine._step

    def located_step(now):
        emitted = step(now)
        for rid, _ in emitted:
            residency[rid] += "h" if engine.requests[rid].location == "cpu" else "d"
        return emitted

    engine._step = located_step
    m, launched, calls, shapes, _ = drive(engine, trace, lambda e, t: run_trace(
        e, t, vocab=cfg.vocab_size, extras_fn=extras_fn))
    engine.close()
    check_paged_launches(cfg, launched, calls, label)
    s = engine.stats
    done = [r for r in engine.requests.values() if r.state.name == "FINISHED"]
    if len(done) != len(trace):
        raise AssertionError(f"{label}: only {len(done)}/{len(trace)} requests finished")
    if not (s.offloaded_decodes > 0 and s.device_decodes > 0 and engine.pool.swap_bytes > 0):
        raise AssertionError(f"{label}: the neo policy did not offload (offloaded="
                             f"{s.offloaded_decodes}, swap bytes {engine.pool.swap_bytes})")
    if pipeline and s.swap_out_bytes + s.swap_in_bytes <= 0:
        raise AssertionError(f"{label}: no swap went through the TransferEngine")
    summary = {**serve_summary(cfg, engine, m, launched, calls, card),
               "prompt_tokens": sum(t.prompt_len for t in trace), "prefill_shapes": shapes,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "init_s": init_s}
    tokens = {rid: list(r.out_tokens) for rid, r in engine.requests.items()}
    # drop the counting wrappers (each holds the engine in a cycle) so the
    # model's memory goes back to the card now, not at the next collection
    del engine._step
    for name in ("decode", "decode_batch0", "prefill"):
        del engine.executor.__dict__[name]
    del engine, step, located_step
    free_card(torch)
    summary["allocated_after_GB"] = torch.cuda.memory_allocated() / 1e9
    return tokens, summary, dict(residency)


def moe_phase_a(torch, card):
    """(a) deepseek-moe-16b, bf16, full width and depth: serial, then
    pipelined, on one trace and the same seeded weights."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    # seed 24: the three device rows fill the pool, so growing them swaps one out
    trace = p11_trace(cfg.vocab_size, 24, 256, 512)
    ser_tok, ser, ser_where = paged_serve(torch, cfg, trace, card, pipeline=False,
                                          label="moe phase (a) serial")
    pip_tok, pip, pip_where = paged_serve(torch, cfg, trace, card, pipeline=True,
                                          label="moe phase (a) pipelined")
    same = sum(x == y for rid in pip_tok for x, y in zip(pip_tok[rid], ser_tok[rid]))
    total = sum(len(v) for v in pip_tok.values())
    pip.update(tokens_equal_to_serial=same, tokens=total,
               residency_equal_to_serial=pip_where == ser_where)
    for rid in sorted(pip_tok):
        if pip_tok[rid] != ser_tok[rid]:
            first = next(i for i, (a, b) in enumerate(zip(pip_tok[rid], ser_tok[rid])) if a != b)
            log(f"[moe] (a) rid {rid} differs from token {first}; residency per token "
                f"(d = card, h = host) serial {ser_where[rid]} pipelined {pip_where[rid]}")
    log(json.dumps({"moe": ser}))
    log(json.dumps({"moe": pip}))
    # asserted: through the executor's 64-row slices a row of deepseek's decode
    # step is bitwise the same in buckets 8-128 (tests/test_torch_moe_card.py)
    log(f"[moe] (a) {cfg.name} bf16 pipelined vs serial: {same} of {total} tokens equal "
        "(asserted)")
    if same != total:
        raise AssertionError(f"moe phase (a): {same} of {total} bf16 tokens equal serial's")
    return ser, pip, trace


def moe_phase_b(torch, trace, card):
    """(b) deepseek-moe-16b in fp32 at full width and MOE_FP32_LAYERS deep,
    pipelined, pools 64/512: every emitted token must be its oracle's argmax
    or a near-tie.  A moe layer's capacity follows the padded S of the
    prefill batch a row came in, so the oracle prefills each prompt alone,
    padded to that S (true_lens), with the plain attention, then decodes
    teacher-forced over the contiguous cache (T = 1, capacity 1: nothing
    drops there).  A recompute replay would prefill at another S: none may
    happen."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.executor import _bucket

    cfg32 = get_config(MOE_ARCH).replace(num_layers=MOE_FP32_LAYERS, param_dtype="float32",
                                         activation_dtype="float32")
    engine = NeoEngine(cfg32, dataclasses.replace(engine_config(64, 512, pipeline=True),
                                                  ewma_alpha=0.0), device="cuda")
    batch_s, prefill = {}, engine.executor.prefill

    def recorded(reqs, to_host, extras_fn=None):
        S = _bucket(max(r.prefill_len for r in reqs), 16)
        for r in reqs:
            batch_s.setdefault(r.rid, []).append(S)
        return prefill(reqs, to_host, extras_fn)

    engine.executor.prefill = recorded
    rids = [engine.submit(t.prompt, t.output_len) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    s = engine.stats
    preempts = sum(int(p.split("preempt=")[1].split()[0]) for p in s.plans)
    if preempts or any(len(v) != 1 for v in batch_s.values()):
        raise AssertionError(f"moe phase (b): {preempts} preemptions, prefills {batch_s}")
    if s.offloaded_decodes <= 0:
        raise AssertionError("moe phase (b): nothing was offloaded")
    model = engine.model
    exact = ties = total = 0
    worst_gap = 0.0
    for rid, t in zip(rids, trace):
        out, S, n = outs[rid], batch_s[rid][0], t.prompt_len
        tok = torch.zeros(1, S, dtype=torch.long)
        tok[0, :n] = torch.tensor(t.prompt)
        logits, cache = model.prefill(tok, capacity=S + P11_OUT, impl="plain",
                                      true_lens=torch.tensor([n], dtype=torch.int32))
        for i, got in enumerate(out):
            want = int(logits[0].argmax())
            gap = float(logits[0, want] - logits[0, got])
            total += 1
            exact += got == want
            if got != want:
                if gap > NEAR_TIE:
                    raise AssertionError(f"moe phase (b): rid {rid} token {i}: engine {got}, "
                                         f"oracle {want}, logit gap {gap:.3e} > {NEAR_TIE}")
                ties += 1
                worst_gap = max(worst_gap, gap)
            if i + 1 < len(out):
                logits, cache = model.decode(torch.tensor([got]), cache)
    out = dict(model=cfg32.name, layers=MOE_FP32_LAYERS, dtype="float32", tokens=total,
               exact=exact, near_ties=ties, worst_tie_gap=worst_gap, preemptions=preempts,
               prefill_S=sorted({v[0] for v in batch_s.values()}),
               offloaded_decodes=s.offloaded_decodes, device_decodes=s.device_decodes,
               card=card)
    del engine, model, cache
    free_card(torch)
    return out


def vlm_phase(torch, card):
    """(c) internvl2-1b, full width and depth: 8 image requests (256 seeded
    patch embeddings each, then 64-256 text tokens), bf16 through the
    pipelined engine (K1 and K2 counted), then fp32 held token for token to
    the dense plain oracle with the same patches."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NeoEngine

    cfg = get_config(VLM_ARCH)
    P = cfg.modality.num_embeds
    # seed 34: at 256 patches the three device rows fill the pool (swaps)
    trace = p11_trace(cfg.vocab_size, 34, 64, 256, image=P)
    table, extras_fn = seeded_extras(trace, "patch_embeds", (P, cfg.d_model), 24, scale=0.02)
    _, bf16, _ = paged_serve(torch, cfg, trace, card, pipeline=True, extras_fn=extras_fn,
                             label="vlm phase bf16")
    log(json.dumps({"vlm": bf16}))
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    engine = NeoEngine(cfg32, engine_config(64, 512, pipeline=True), device="cuda")
    rids = [engine.submit(t.prompt, t.output_len, extras=table[id(t)]) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    counts = dense_oracle_parity(torch, engine.model,
                                 [(rid, t.prompt, outs[rid]) for rid, t in zip(rids, trace)],
                                 patches={rid: table[id(t)]["patch_embeds"]
                                          for rid, t in zip(rids, trace)})
    parity = dict(model=cfg.name, dtype="float32", **counts,
                  offloaded_decodes=engine.stats.offloaded_decodes, card=card)
    del engine
    free_card(torch)
    return bf16, parity


def int8_phase(torch, card, *, prompt_len=256, steps=8):
    """(d) The int8 KV cache, deepseek-moe-16b at full width in bf16: one
    prompt through ``DenseLM.prefill`` and ``decode`` with
    ``kv_cache_dtype="int8"`` beside the bf16 cache, on the same weights
    (the int8 model is a shallow copy sharing the bf16 model's parameters).
    Every dequantised prefill K/V entry must lie within half a scale step of
    the bf16 cache's value (the same K/V, quantised); the greedy agreement
    over ``steps`` decode steps (each side feeding its own argmax) and the
    largest |logit difference| are recorded, as the reference's test
    measures them, not asserted at random weights."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(MOE_ARCH)
    model = get_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    int8 = copy.copy(model)
    int8.cfg = cfg.replace(kv_cache_dtype="int8")
    prompt = np.random.default_rng(29).integers(1, cfg.vocab_size, size=prompt_len)
    tok = torch.tensor(prompt[None], device="cuda")
    cap = prompt_len + steps
    lo, c = model.prefill(tok, capacity=cap)
    lo8, c8 = int8.prefill(tok, capacity=cap)
    half_steps = {}
    for name in ("k", "v"):
        scale = c8[name + "_scale"][:, :, :prompt_len].float()
        deq = c8[name][:, :, :prompt_len].float() * scale[..., None]
        err = (deq - c[name][:, :, :prompt_len].float()).abs() / scale[..., None]
        half_steps[name] = float(err.max())
        if half_steps[name] > 0.5 * (1 + 1e-3):
            raise AssertionError(f"int8 phase: a dequantised {name} entry lies "
                                 f"{half_steps[name]:.4f} scale steps from the bf16 cache's")
    agree = int(int(lo.argmax()) == int(lo8.argmax()))
    worst = float((lo - lo8).abs().max())
    for _ in range(steps):
        lo, c = model.decode(lo.argmax(-1), c)
        lo8, c8 = int8.decode(lo8.argmax(-1), c8)
        agree += int(int(lo.argmax()) == int(lo8.argmax()))
        worst = max(worst, float((lo - lo8).abs().max()))
    cache_bytes = {"bf16": sum(c[n].numel() * c[n].element_size() for n in ("k", "v")),
                   "int8": sum(c8[n].numel() * c8[n].element_size()
                               for n in ("k", "v", "k_scale", "v_scale"))}
    out = dict(model=cfg.name, prompt=prompt_len, steps=steps,
               greedy_agree=f"{agree}/{steps + 1}", max_abs_logit_diff=worst,
               max_prefill_err_in_scale_steps=half_steps, cache_bytes=cache_bytes, card=card)
    del model, int8, c, c8
    free_card(torch)
    return out


def audio_engine_config(tracing=False):
    from repro_torch.config import EngineConfig

    return EngineConfig(max_requests=8, max_batch_tokens=512, policy="neo", pipeline=False,
                        hw_profile="h100_sxm", seed=0, tracing=tracing)


def audio_phase(torch, card):
    """3f. seamless-m4t-medium, bf16, full width, on the contiguous engine:
    8 requests with AUDIO_FRAMES seeded frames each and prompts of 64-256
    tokens; K2 = 24 x prefills (12 non-causal encoder and 12 causal decoder
    layers), no other kernel.  Then in fp32 every token held to the model's
    own plain prefill plus teacher-forced decode."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import NeoEngine
    from repro_torch.launch.serve import run_trace

    cfg = get_config(AUDIO_ARCH)
    trace = p11_trace(cfg.vocab_size, 31, 64, 256)
    table, extras_fn = seeded_extras(trace, "frames", (AUDIO_FRAMES, cfg.d_model), 32)
    torch.cuda.reset_peak_memory_stats()
    engine = NeoEngine(cfg, audio_engine_config(), device="cuda")
    if engine.paged:
        raise AssertionError(f"{cfg.name} took the paged path")
    calls, prefill = [0], engine.executor.prefill

    def counted(*a, **k):
        calls[0] += 1
        return prefill(*a, **k)

    engine.executor.prefill = counted
    zero_counters()
    m = run_trace(engine, trace, vocab=cfg.vocab_size, extras_fn=extras_fn)
    launched = counters()
    engine.close()
    want = {k: 0 for k in launched}
    want["flash_prefill"] = (cfg.encdec.encoder_layers + cfg.num_layers) * calls[0]
    if launched != want or calls[0] != len(trace):
        raise AssertionError(f"audio phase: launches {launched} != {want} ({calls[0]} "
                             f"prefills of {len(trace)} requests)")
    s = engine.stats
    summary = {"model": cfg.name, "dtype": cfg.activation_dtype, "frames": AUDIO_FRAMES,
               "requests": len(m.finished), "prompt_tokens": sum(t.prompt_len for t in trace),
               "output_tok_s": m.throughput, "ttft_s": m.ttft(), "tpot_s": m.tpot(),
               "makespan_s": m.makespan, "iterations": s.iterations, "prefills": calls[0],
               "lane_busy_s": dict(s.lane_busy_time), "kernel_launches": launched,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    del engine
    free_card(torch)
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    engine = NeoEngine(cfg32, audio_engine_config(), device="cuda")
    rids = [engine.submit(t.prompt, t.output_len, extras=table[id(t)]) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    model = engine.model
    exact = ties = total = 0
    worst_gap = 0.0
    for rid, t in zip(rids, trace):
        out = outs[rid]
        frames = torch.from_numpy(table[id(t)]["frames"])[None]
        logits, cache = model.prefill(torch.tensor([t.prompt]), capacity=t.prompt_len + P11_OUT,
                                      frames=frames, impl="plain")
        for i, got in enumerate(out):
            want = int(logits[0].argmax())
            gap = float(logits[0, want] - logits[0, got])
            total += 1
            exact += got == want
            if got != want:
                if gap > NEAR_TIE:
                    raise AssertionError(f"audio parity: rid {rid} token {i}: engine {got}, "
                                         f"oracle {want}, logit gap {gap:.3e} > {NEAR_TIE}")
                ties += 1
                worst_gap = max(worst_gap, gap)
            if i + 1 < len(out):
                logits, cache = model.decode(torch.tensor([got]), cache)
    parity = dict(model=cfg.name, dtype="float32", tokens=total, exact=exact, near_ties=ties,
                  worst_tie_gap=worst_gap, card=card)
    del engine, model, cache
    free_card(torch)
    return summary, parity


def p11_phase(torch, card):
    """Phases 3e (a)-(d) and 3f, each summary printed as it ends."""
    t0 = time.perf_counter()
    ser, pip, trace = moe_phase_a(torch, card)
    moe32 = moe_phase_b(torch, trace, card)
    log(json.dumps({"parity": moe32}))
    vlm, vlm32 = vlm_phase(torch, card)
    log(json.dumps({"parity": vlm32}))
    int8 = int8_phase(torch, card)
    log(json.dumps({"int8": int8}))
    audio, audio32 = audio_phase(torch, card)
    log(json.dumps({"audio": audio}))
    log(json.dumps({"parity": audio32}))
    log(f"[p11] deepseek bf16 pipelined = serial {pip['tokens_equal_to_serial']}/"
        f"{pip['tokens']}; fp32 {MOE_FP32_LAYERS}-layer parity {moe32['exact']}+"
        f"{moe32['near_ties']}/{moe32['tokens']}; internvl2 fp32 parity "
        f"{vlm32['exact']}+{vlm32['near_ties']}/{vlm32['tokens']}; int8 greedy "
        f"{int8['greedy_agree']}, max |dlogit| {int8['max_abs_logit_diff']:.4f}; seamless fp32 "
        f"parity {audio32['exact']}+{audio32['near_ties']}/{audio32['tokens']}; phases "
        f"{time.perf_counter() - t0:.1f} s")
    return {"moe_serial": ser, "moe_pipelined": pip, "vlm": vlm, "audio": audio}


# ---------------------------------------------------------------------------
# phase 3g: gather-TP tensor parallelism, every shard on cuda:0
# ---------------------------------------------------------------------------

TP_SHARD_HEADS = {"tp2": (8, 4), "tp4": (4, 2), "qwen3_14b_tp2": (20, 4)}  # H/tp, KV/tp
TP_BIG = "qwen3-14b"
TP_BIG_REQUESTS, TP_BIG_OUTPUT = 4, 16


def tp_kernel_phase(torch):
    """K1 and K2 at 3g's shard shapes (query/KV heads per shard: 8/4 and 4/2
    for qwen3-0.6b at tp 2 and 4, 20/4 for qwen3-14b at tp 2; hd 128),
    against their plain versions in fp32 and bf16, then timed in bf16 (L2
    flushed) beside SDPA and their bound: K1 over 8 rows of the serve
    cell's lengths, K2 over one 512-token prompt."""
    import random

    from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    rng = random.Random(20)
    lens = [rng.randint(257, 800) for _ in range(8)]  # prompts 256-768 + 32 outputs
    decode_worst = {}
    for label, (H, KV) in TP_SHARD_HEADS.items():
        for dt_name in ("float32", "bfloat16"):
            q, kp, vp, bt, ln = make_case(torch, 8, H, KV, 128, 16, lens,
                                          getattr(torch, dt_name), seed=60 + H)
            out = kern(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            err = _close(torch, "paged_decode", dt_name, f"shard {label}",
                         [("o", out, paged_decode_ref(q, kp, vp, bt, ln))])
            decode_worst[dt_name] = max(decode_worst.get(dt_name, 0.0), err)
            log(f"[kernel] paged_decode {dt_name} shard {label} B=8 H={H} KV={KV} hd=128 "
                f"lens={lens} max_abs_err={err:.3e} tol={TOL[dt_name]} ok")
    flash_worst = flash_sweep(torch, [dict(B=1, S=512, H=H, KV=KV, hd=128, causal=True,
                                           window=0) for H, KV in TP_SHARD_HEADS.values()],
                              seed=600)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {}
    for label, (H, KV) in TP_SHARD_HEADS.items():
        timed[f"decode_{label}"] = decode_time(torch, flush, f"shard {label}", 8, H, KV, 128,
                                               lens)
        timed[f"prefill_{label}"] = flash_time(torch, flush, f"shard {label}", 1, 512, H, KV,
                                               128, 0)
    del flush
    return timed, decode_worst, flash_worst


def tp_run(torch, cfg, trace, tp, card, *, device_pages, host_pages, tracing=False, label=""):
    """``trace`` through ``launch.serve.run_trace`` on the pipelined paged
    engine at ``tp`` shards, every shard on cuda:0 (``shard_devices``), the
    perf model frozen, counted by :func:`drive`: K1 = tp x layers x decode
    passes (with merges), K2 = tp x layers x prefill calls.  Returns
    (engine, summary with the peak memory)."""
    from repro_torch.config import EngineConfig
    from repro_torch.core.engine import NeoEngine
    from repro_torch.launch.serve import run_trace

    ecfg = EngineConfig(device_pool_pages=device_pages, host_pool_pages=host_pages,
                        policy="neo", pipeline=True, hw_profile="h100_sxm", seed=0,
                        ewma_alpha=0.0, tp=tp, tracing=tracing)
    torch.cuda.reset_peak_memory_stats()
    engine = NeoEngine(cfg, ecfg, device="cuda",
                       shard_devices=["cuda:0"] * tp if tp > 1 else None)
    m, launched, calls, _, _ = drive(engine, trace, lambda e, t: run_trace(
        e, t, vocab=cfg.vocab_size))
    engine.close()
    done = [r for r in engine.requests.values() if r.state.name == "FINISHED"]
    if len(done) != len(trace):
        raise AssertionError(f"tp phase {label}: only {len(done)}/{len(trace)} finished")
    L = cfg.num_layers
    passes = calls["decode"] + calls["decode_batch0"]
    want = {"paged_decode": tp * L * passes, "flash_prefill": tp * L * calls["prefill"],
            "rwkv6_scan": 0, "mamba2_ssd": 0}
    got = {k: launched[k] for k in want}
    if got != want or passes == 0 or calls["prefill"] == 0:
        raise AssertionError(f"tp phase {label}: launches {got} != {want} ({tp} shards x {L} "
                             f"layers x {calls})")
    if not 0 < launched["paged_decode_merge"] <= launched["paged_decode"]:
        raise AssertionError(f"tp phase {label}: merge launches "
                             f"{launched['paged_decode_merge']}")
    summary = serve_summary(cfg, engine, m, launched, calls, card)
    ts = engine.transfer.stats
    summary.update(run=label, tp=tp, shard_devices=[str(d) for d in engine.shard_devices],
                   peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
                   bytes_by_stream=dict(sorted(ts.bytes_by_stream.items())))
    return engine, summary


def tp_compare(runs, base):
    """(tokens equal to ``base``'s, tokens, plans equal) for each run."""
    out = {}
    for key, (tokens, plans, _) in runs.items():
        b_tokens, b_plans, _ = runs[base]
        same = sum(a == b for rid, t in tokens.items() for a, b in zip(t, b_tokens[rid]))
        out[key] = (same, sum(map(len, b_tokens.values())), plans == b_plans)
    return out


def tp_phase_a(torch, card):
    """(a) qwen3-0.6b bf16 at TP 1, 2 and 4, pools 512/512 (every row on the
    card), the serve phase's 8 requests: tokens of TP 2 and 4 = TP 1's
    bitwise (the reference's claim), K1 / K2 launched tp times per layer."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-0.6b")
    trace = make_trace(8, cfg.vocab_size)
    runs = {}
    for tp in (1, 2, 4):
        engine, summary = tp_run(torch, cfg, trace, tp, card, device_pages=512, host_pages=512,
                                 label=f"a: tp={tp}")
        if engine.stats.offloaded_decodes or engine.pool.swap_bytes:
            raise AssertionError(f"tp phase (a) tp={tp}: a row left the card "
                                 f"({engine.stats.offloaded_decodes} host decodes)")
        runs[tp] = (spec_tokens(engine), list(engine.stats.plans), summary)
        del engine
        free_card(torch)
    for tp, (same, total, plans) in tp_compare(runs, 1).items():
        runs[tp][2].update(tokens_equal_to_tp1=same, tokens=total, plans_equal_to_tp1=plans)
        log(json.dumps({"tp": runs[tp][2]}))
    for tp, (same, total, _) in tp_compare(runs, 1).items():
        if same != total or total == 0:
            raise AssertionError(f"tp phase (a): tp={tp} gives {same} of {total} bf16 tokens "
                                 "of tp=1")
    return {tp: run[2] for tp, run in runs.items()}


def tp_phase_b(torch, card):
    """(b) qwen3-0.6b at TP=2 with the serve cell's pools 64/512 (neo
    offloads): fp32, every token the dense oracle's argmax or a near-tie;
    bf16 traced, the per-shard copy streams partition the run's own swap
    totals exactly, obs.validate accepts the export with per-shard
    host-attention and copy tracks, reconcile() passes; bf16 TP=1 on the
    same trace for the record (TP=2's perf model prices two cards, so its
    plans, and with them the rows' residency, may differ)."""
    from repro_torch.configs import get_config
    from repro_torch.obs import reconcile
    from repro_torch.obs.validate import validate

    cfg = get_config("qwen3-0.6b").replace(num_layers=HOST_PHASE_LAYERS)
    trace = make_trace(8, cfg.vocab_size)
    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    out = {}
    engine, s32 = tp_run(torch, cfg32, trace, 2, card, device_pages=64, host_pages=512,
                         label="b: fp32 tp=2")
    if not (engine.stats.offloaded_decodes > 0 and engine.pool.swap_bytes > 0):
        raise AssertionError(f"tp phase (b) fp32: nothing offloaded ({s32['modes']})")
    s32["parity"] = dense_oracle_parity(torch, engine.model, [
        (rid, r.prompt, list(r.out_tokens)) for rid, r in sorted(engine.requests.items())])
    out["fp32"] = s32
    log(json.dumps({"tp": s32}))
    del engine
    free_card(torch)

    runs = {}
    for tp, tracing in ((2, True), (1, False)):
        engine, summary = tp_run(torch, cfg, trace, tp, card, device_pages=64, host_pages=512,
                                 tracing=tracing, label=f"b: bf16 tp={tp}"
                                 + (", traced" if tracing else ""))
        if tracing:
            ts, tr = engine.transfer.stats, engine.tracer
            st = ts.bytes_by_stream
            outs = {k: v for k, v in st.items() if k.startswith("out")}
            ins = {k: v for k, v in st.items() if k.startswith("in")}
            if not (set(outs) == {"out0", "out1"} and ts.bytes_out > 0
                    and sum(outs.values()) == ts.bytes_out == engine.stats.swap_out_bytes
                    and sum(ins.values()) == ts.bytes_in == engine.stats.swap_in_bytes
                    and outs["out0"] == outs["out1"]
                    and len(set(ins.values())) <= 1 and set(ins) <= {"in0", "in1"}):
                raise AssertionError(f"tp phase (b): the stream split {st} does not partition "
                                     f"the swaps ({ts.bytes_out} out, {ts.bytes_in} in)")
            if tr.dropped:
                raise AssertionError(f"tp phase (b): the tracer dropped {tr.dropped} events")
            rep = reconcile(tr, engine.stats)
            if not rep.ok:
                raise AssertionError(f"tp phase (b): reconcile failed {rep.failed()}")
            path = os.path.join(ROOT, "build", "chip_smoke_trace_tp2.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tr.export_chrome(path)
            fails = validate(path, expect_copy=True)
            need = {"hostattn-b0-s0", "hostattn-b0-s1", "copy-out0", "copy-out1"}
            if fails or not need <= set(tr.tracks()):
                raise AssertionError(f"tp phase (b): obs.validate {fails}, tracks "
                                     f"{tr.tracks()}")
            summary.update(traced=True, tracks=tr.tracks(), events_recorded=tr.total,
                           reconcile_checks=len(rep.checks), reconcile_ok=rep.ok,
                           validate_fails=fails)
        runs[tp] = (spec_tokens(engine), list(engine.stats.plans), summary)
        del engine
        free_card(torch)
    same, total, plans = tp_compare(runs, 1)[2]
    runs[2][2].update(tokens_equal_to_tp1=same, tokens=total, plans_equal_to_tp1=plans)
    for tp in (2, 1):
        log(json.dumps({"tp": runs[tp][2]}))
    out["bf16_tp2"], out["bf16_tp1"] = runs[2][2], runs[1][2]
    return out


def tp_phase_c(torch, card):
    """(c) qwen3-14b bf16 at TP=2 against TP=1: 4 prompts of 256-512
    tokens, 16 outputs, pools 256/64 (every row on the card); tokens equal
    (asserted) and each run's peak memory (the unsharded weights beside the
    shards' column copies at TP=2) recorded."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serving.traces import TraceRequest

    cfg = get_config(TP_BIG)
    rng = np.random.default_rng(6)
    trace = []
    for _ in range(TP_BIG_REQUESTS):
        n = int(rng.integers(256, 513))
        trace.append(TraceRequest(0.0, n, TP_BIG_OUTPUT,
                                  prompt=list(map(int, rng.integers(1, cfg.vocab_size, n)))))
    runs = {}
    for tp in (1, 2):
        engine, summary = tp_run(torch, cfg, trace, tp, card, device_pages=256, host_pages=64,
                                 label=f"c: {TP_BIG} tp={tp}")
        if engine.stats.offloaded_decodes or engine.pool.swap_bytes:
            raise AssertionError(f"tp phase (c) tp={tp}: a row left the card")
        runs[tp] = (spec_tokens(engine), list(engine.stats.plans), summary)
        del engine
        free_card(torch)
    same, total, plans = tp_compare(runs, 1)[2]
    runs[2][2].update(tokens_equal_to_tp1=same, tokens=total, plans_equal_to_tp1=plans)
    for tp in (1, 2):
        log(json.dumps({"tp": runs[tp][2]}))
    if same != total or total == 0:
        raise AssertionError(f"tp phase (c): tp=2 gives {same} of {total} bf16 tokens of tp=1")
    return {tp: run[2] for tp, run in runs.items()}


def tp_phase_d():
    """(d) ``serve --tp 2`` with no shard devices on a one-card machine
    raises the reference's device-count ValueError (no fallback to the CPU
    or to fewer shards); returns its message."""
    import torch

    from repro_torch.launch import serve

    n = torch.cuda.device_count()
    try:
        serve.main(["--arch", "qwen3-0.6b", "--tp", str(n + 1), "--n", "1"])
    except ValueError as e:
        if f"exceeds the {n} available" not in str(e):
            raise AssertionError(f"tp phase (d): unexpected refusal {e}") from e
        return str(e)
    raise AssertionError(f"tp phase (d): serve --tp {n + 1} on {n} card(s) did not refuse")


def tp_phase(torch, card):
    """Phase 3g: K1/K2 at the shard shapes, then (a)-(d)."""
    t0 = time.perf_counter()
    kern = tp_kernel_phase(torch)
    a = tp_phase_a(torch, card)
    b = tp_phase_b(torch, card)
    c = tp_phase_c(torch, card)
    d = tp_phase_d()
    log(f"[tp] (a) qwen3-0.6b bf16 tokens of tp=1: tp=2 {a[2]['tokens_equal_to_tp1']}, tp=4 "
        f"{a[4]['tokens_equal_to_tp1']} of {a[1]['tokens']} (asserted); makespan tp=1/2/4 "
        + " / ".join(f"{a[tp]['makespan_s']:.3f}" for tp in (1, 2, 4)) + " s; (b) fp32 tp=2 "
        f"parity {b['fp32']['parity']['exact']}+{b['fp32']['parity']['near_ties']}/"
        f"{b['fp32']['parity']['tokens']}, bf16 tp=2 vs tp=1 {b['bf16_tp2']['tokens_equal_to_tp1']}"
        f"/{b['bf16_tp2']['tokens']} (plans equal: {b['bf16_tp2']['plans_equal_to_tp1']}; "
        f"recorded); (c) {TP_BIG} tp=2 = tp=1 {c[2]['tokens_equal_to_tp1']}/{c[2]['tokens']}, "
        f"peak {c[1]['peak_mem_GB']:.1f} / {c[2]['peak_mem_GB']:.1f} GB; (d) {d}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return kern, a, b, c


# ---------------------------------------------------------------------------
# phase 3h: the reference's engine benchmarks and their gates at full width
# ---------------------------------------------------------------------------

# the sizes fit the whole run into its time limit: bench_trend's --n is 12,
# engine_real's 24 and prefix_cache --quick's turns 8 (PERF.md §4)
BENCH_LAYERS = HOST_PHASE_LAYERS  # depth of every bf16 section (full width)
BENCH_N = 3  # bench_trend's --n (the spec section takes max(2, min(n, 3)): 3, its own)
BENCH_POLICY_N = 3  # engine_real's --n for the policy table
BENCH_PREFIX_N = 4  # prefix_cache's turns
BENCH_RECHECK_LAYERS = 4  # depth of the fp32 re-runs (full width)
# host attention threads of the spec section (perf model live, as the
# reference's): with one thread each verify pseudo-row is a full serial
# numpy row attention and the oracle's win came and went around 1.0 on the
# card (PERF.md §6); 8 is the card machine's core count, fixed here so the
# gate's verdict does not follow the machine it runs on
BENCH_SPEC_HOST_THREADS = 8
# sections whose engines serve fastdecode without speculation: every decode
# runs in host lanes (decode_host_lane), so K1 has no launch there
BENCH_HOST_DECODE_ONLY = ("fastdecode", "microbatch", "obs")


class LaunchAudit:
    """The K1 and K2 launches the engines built while it is installed must
    make: shards x layers per executor decode pass (batch-0, serial and
    verify passes alike) and per prefill call with a cold row; checked per
    section, with every launch counter zeroed just before and read just
    after."""

    def __init__(self, d_model, layers, recheck_layers):
        self.want = collections.Counter()
        self.calls = collections.Counter()
        self.record = {}
        self.d_model, self.full_layers, self.recheck_layers = d_model, layers, recheck_layers
        self.layers = layers

    def install(self):
        """Wrap the executor of every paged engine built from now on;
        returns the restorer."""
        from repro_torch.core.engine import NeoEngine

        init, audit = NeoEngine.__init__, self

        def counted_init(engine, *a, **k):
            init(engine, *a, **k)
            if engine.paged:
                audit.wrap(engine)

        NeoEngine.__init__ = counted_init
        return lambda: setattr(NeoEngine, "__init__", init)

    def wrap(self, engine):
        got = (engine.cfg.d_model, engine.cfg.num_layers)
        if got != (self.d_model, self.layers):
            raise AssertionError(f"bench: an engine of d_model {got[0]} and {got[1]} layers "
                                 f"where {self.d_model} and {self.layers} were due")
        ex, per = engine.executor, engine.tp * engine.cfg.num_layers

        def counted(name):
            fn = getattr(ex, name)

            def wrapped(*a, **k):
                self.calls[name] += 1
                if name != "prefill":
                    self.want["paged_decode"] += per
                elif any(r.cached_len == 0 for r in a[0]):
                    self.calls["prefill_with_cold_row"] += 1
                    self.want["flash_prefill"] += per
                return fn(*a, **k)
            return wrapped

        for name in ("decode", "decode_batch0", "prefill"):
            setattr(ex, name, counted(name))

    @contextlib.contextmanager
    def section(self, name):
        self.want.clear()
        self.calls.clear()
        self.layers = (self.recheck_layers if name.endswith("_float32")
                       else self.full_layers)
        zero_counters()
        yield
        launched = counters()
        want = {"paged_decode": self.want["paged_decode"],
                "flash_prefill": self.want["flash_prefill"], "rwkv6_scan": 0, "mamba2_ssd": 0}
        got = {k: launched[k] for k in want}
        host_only = name in BENCH_HOST_DECODE_ONLY
        if (got != want or (want["paged_decode"] == 0) != host_only
                or want["flash_prefill"] == 0
                or launched["paged_decode_merge"] > launched["paged_decode"]):
            raise AssertionError(f"bench {name}: launches {got} != {want} (merges "
                                 f"{launched['paged_decode_merge']}; calls {dict(self.calls)})")
        self.record[name] = {**got, "paged_decode_merge": launched["paged_decode_merge"],
                             "executor_calls": dict(self.calls)}


def bench_phase(torch, card, *, n=BENCH_N, policy_n=BENCH_POLICY_N, prefix_n=BENCH_PREFIX_N):
    """engine_real's default policy table once (recorded), then
    ``repro_torch.benchmarks.bench_trend.collect`` at full width on the card
    (qwen3-0.6b bf16 at ``BENCH_LAYERS`` layers, the reference's traces and
    pools in pages, perf model frozen but for the spec section, which runs it live on
    ``BENCH_SPEC_HOST_THREADS`` host threads) with the table's fastdecode
    burst as its shared run; prefix cache on = off and the sustained loops'
    bitwise claims asserted in fp32 at full width and 4 layers (their bf16
    matches printed as a record), every other gate in bf16; every engine's
    width and depth and its K1/K2 launches checked per section; the summary
    gated against ``BENCH_baseline_h100.json``.  One JSON line per
    section."""
    from repro_torch.benchmarks import bench_trend, engine_real
    from repro_torch.benchmarks.common import bench_config, free_params

    t0 = time.perf_counter()
    full = bench_config("qwen3-0.6b", layers=BENCH_LAYERS)
    audit = LaunchAudit(full.d_model, full.num_layers, BENCH_RECHECK_LAYERS)
    restore = audit.install()
    raw = {"wall_s": {}}
    try:
        t_table = time.perf_counter()
        with audit.section("policy_table"):
            table, fastdecode = engine_real.run_policy_table(policy_n, device="cuda",
                                                             layers=BENCH_LAYERS, ewma_alpha=0.0)
        raw["wall_s"]["policy_table"] = round(time.perf_counter() - t_table, 2)
        free_card(torch)
        rc, summary = bench_trend.collect(
            n, bitwise_dtype="float32", recheck_layers=BENCH_RECHECK_LAYERS,
            prefix_n=prefix_n, spec_ewma_alpha=None, spec_host_threads=BENCH_SPEC_HOST_THREADS,
            fastdecode=fastdecode if policy_n == n else None, raw=raw, log=log,
            section=audit.section, device="cuda", layers=BENCH_LAYERS, ewma_alpha=0.0)
    finally:
        restore()
        free_params()
        free_card(torch)
    er = raw["engine_real"]
    results = {
        "microbatch": {k: er[k] for k in ("fastdecode_mb_off", "fastdecode_mb_on")},
        "mixed_lane": {k: er[k] for k in ("mixed_serial", "mixed_pipelined")},
        "obs": {k: er[k] for k in ("obs_tracing_off", "obs_tracing_on")},
        "spec": {k: er[k] for k in ("spec_off", "spec_ngram", "spec_oracle", "spec_gates")},
        "prefix_cache": raw["prefix_cache"], "sharded": raw["sharded"],
        "sustained": raw["sustained"], "policy_table": table}
    for claim in bench_trend.RECHECK:
        results[f"{claim}_float32"] = raw[f"{claim}_check"]
    for name, res in results.items():
        log(json.dumps({"bench": {"section": name, "card": card,
                                  "wall_s": raw["wall_s"].get(name),
                                  "rc": raw["rc"].get(name),
                                  "kernel_launches": audit.record.get(name),
                                  "results": res}}))
    log(json.dumps({"bench_summary": summary}))
    rec = summary["bitwise_record"]
    log(f"[bench] prefix cache on = off and open = closed loop asserted in "
        f"{rec['asserted_in']} at {rec['recheck_layers']} layers; bf16 tokens equal (record): "
        + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in rec.items() if isinstance(v, list)))
    log("[bench] policy table (bf16, OSC burst of %d): " % policy_n
        + ", ".join(f"{k} {r['token_throughput']} tok/s ({r['requests_done']} done, "
                    f"{r['wall_s']} s)" for k, r in table.items()))
    if rc:
        raise AssertionError(f"bench phase: a section's gate failed: {raw['rc']}")
    with open(bench_trend.H100_BASELINE_PATH) as f:
        baseline = json.load(f)
    verdict = io.StringIO()
    with contextlib.redirect_stdout(verdict):
        fails = bench_trend.gate(summary, baseline)
    log(verdict.getvalue().rstrip())
    if fails:
        # the failed gates' own lines go into the error, which stderr carries
        raise AssertionError(f"bench phase: {fails} bench_trend gate(s) failed against "
                             f"{os.path.relpath(bench_trend.H100_BASELINE_PATH, ROOT)}:\n"
                             + verdict.getvalue().rstrip())
    log(f"[bench] all gates passed; phase {time.perf_counter() - t0:.1f} s (sections: "
        + json.dumps(raw["wall_s"]) + ")")
    return summary, audit.record, table


# serve_online's --n (its default 12), cut for time: the CPU rehearsal of
# the fp32 crash run replays 5 requests at 9 as at 12
EXAMPLES_N = 9
# virtual seconds per clock reading of 3i's fp32 serve_online runs: the
# crash leaves five requests to replay, which decode on the recovered
# engine (the CPU rehearsal with the full config's perf model and
# scheduler, which set the schedule, not the weights)
EXAMPLES_TICK = 0.05


def run_example(fn, *a, **k):
    """``fn(*a, **k)`` with its stdout kept (the examples print a line per
    iteration); returns (result, the printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return res, buf.getvalue().splitlines()


def examples_phase(torch, card, *, n=EXAMPLES_N):
    """Phase 3i: quickstart and serve_online at full width through their
    entry points, K1/K2 launches audited per run (``LaunchAudit``, counters
    zeroed just before each run and read just after).  Asserts quickstart's
    fp32 NEO = GPU-only with offloaded decodes, and serve_online's fp32
    crash run (virtual clock, perf model frozen) = its crash-free run with
    at least one replay; the bf16 runs are records.  One JSON line each."""
    from repro_torch.benchmarks.common import bench_config
    from repro_torch.examples import quickstart, serve_online

    t0 = time.perf_counter()
    full = bench_config("qwen3-0.6b")
    audit = LaunchAudit(full.d_model, full.num_layers, full.num_layers)
    restore = audit.install()
    out = {}

    def record(name, summary, lines):
        out[name] = {**summary, "kernel_launches": audit.record[name], "card": card}
        log(json.dumps({"examples": {"run": name, **out[name]}}))
        for line in lines[-3:]:
            if line.strip():
                log(f"[examples] {name}: {line}")

    def serve(name, dtype, crash, virtual):
        argv = ["--full", "--dtype", dtype, "--n", str(n)] + (["--crash"] if crash else [])
        kw = {}
        if virtual:
            clk = serve_online.VirtualClock(EXAMPLES_TICK)
            kw = dict(clock=clk.perf_counter, sleep=clk.sleep, ewma_alpha=0.0)
        t = time.perf_counter()
        with audit.section(name):
            res, lines = run_example(serve_online.main, argv, **kw)
        wall = time.perf_counter() - t
        free_card(torch)
        record(name, {"served": res["served"], "recovered": res["recovered"],
                      "makespan_s": res["makespan_s"], "clock": "virtual" if virtual else "wall",
                      "wall_s": wall, "iterations": res["iterations"], **res["stats"]}, lines)
        return res

    try:
        # (a) quickstart: fp32 asserted by the example itself, bf16 counted
        with audit.section("quickstart_float32"):
            q32, lines = run_example(quickstart.main, ["--full", "--dtype", "float32"])
        free_card(torch)
        if q32["stats"]["neo"]["offloaded_decodes"] == 0:
            raise AssertionError(f"examples: quickstart fp32 offloaded no decode: {q32['stats']}")
        record("quickstart_float32", {"neo_equals_gpu_only": q32["same"], **q32["stats"]},
               lines)
        with audit.section("quickstart_bfloat16"):
            q16, lines = run_example(quickstart.run, bench_config("qwen3-0.6b", dtype="bfloat16"),
                                     "cuda")
        free_card(torch)
        outs = q16["outputs"]
        pairs = [(a, b) for r in outs["neo"] for a, b in zip(outs["neo"][r], outs["gpu_only"][r])]
        eq = sum(a == b for a, b in pairs)
        record("quickstart_bfloat16", {"tokens_equal_to_gpu_only": [eq, len(pairs)],
                                       **q16["stats"]}, lines)
        log(f"[examples] quickstart bf16 (record): {eq} of {len(pairs)} NEO tokens equal "
            "to GPU-only's")

        # (b) serve_online --crash: fp32 on a virtual clock asserted, bf16 a record
        c32 = serve("serve_online_crash_float32", "float32", True, True)
        f32 = serve("serve_online_float32", "float32", False, True)
        if c32["recovered"] < 1:
            raise AssertionError("examples: the fp32 crash run replayed no request")
        same = sum(c32["tokens"][p] == f32["tokens"][p] for p in f32["tokens"])
        if c32["tokens"] != f32["tokens"]:
            raise AssertionError(f"examples: fp32 crash run tokens equal the crash-free "
                                 f"run's for {same} of {len(f32['tokens'])} requests")
        log(f"[examples] serve_online fp32 --crash (virtual clock): {c32['recovered']} "
            f"replayed, every request's tokens = the crash-free run's ({same}/{same}, "
            "asserted)")
        c16 = serve("serve_online_crash_bfloat16", "bfloat16", True, False)
        f16 = serve("serve_online_bfloat16", "bfloat16", False, False)
        rep = [(a, b) for p in c16["replayed"] for a, b in zip(c16["tokens"][p],
                                                               f16["tokens"][p])]
        rec = {"recovered": c16["recovered"],
               "replayed_tokens_equal_to_crash_free": [sum(a == b for a, b in rep), len(rep)],
               "requests_equal_to_crash_free": [
                   sum(c16["tokens"][p] == f16["tokens"][p] for p in f16["tokens"]),
                   len(f16["tokens"])]}
        out["serve_online_crash_bfloat16"].update(rec)
        launched = out["serve_online_crash_bfloat16"]["kernel_launches"]
        log(f"[examples] serve_online bf16 --crash (wall clock, record): served {n}, "
            f"recovered {c16['recovered']}, makespan {c16['makespan_s']:.3f} s, "
            f"K1 {launched['paged_decode']}, K2 {launched['flash_prefill']}; replayed "
            f"tokens equal to the crash-free run's {rec['replayed_tokens_equal_to_crash_free']}"
            f", whole requests {rec['requests_equal_to_crash_free']}")
    finally:
        restore()
        free_card(torch)
    log(f"[examples] phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 3j: training on one card
# ---------------------------------------------------------------------------

TRAIN_PARITY_LAYERS = 4  # depth of 3j (a)'s fp32 parity (full width)
# 3j (b): bf16 qwen3-0.6b, all 28 layers, batch 8 x 512; cut from 30 steps
# to make room for phase 3k (PERF.md §4)
TRAIN_STEPS = 20
# 3j (d): train_mini's steps, cut from its default 300 for time, and from
# 50 for phase 3k (PERF.md §4)
TRAIN_MINI_STEPS = 30
LOSS_RTOL = 1e-5  # 3j (a), (c): card vs CPU loss, as the CPU tests hold port to reference
GRAD_TOL = 1e-4  # ... each leaf's gradient within this of the largest entry
OPT_TOL = 1e-6  # ... the optimizer update, of each leaf's largest entry
RESUME_TOL = 2e-5  # 3 + resume + 3 steps vs 6: the reference's own resume tolerance


def seeded(torch, model, seed):
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def train_grads(torch, cfg, state, batch, device):
    """(loss, aux, {name: gradient} on the CPU) of ``cfg``'s model with the
    weights ``state`` on ``device``, through the trainer's value_and_grad."""
    from repro_torch.models.api import get_model
    from repro_torch.train.trainer import trainable, value_and_grad

    model = get_model(cfg, device=device)
    model.load_state_dict(state)
    params = trainable(model)
    loss, aux, grads = value_and_grad(model, params, {k: v.to(device) for k, v in batch.items()})
    out = (float(loss), float(aux["aux"]), {k: g.cpu() for k, g in grads.items()})
    del model, params, grads
    return out


def card_vs_cpu(torch, cfg, seed, batch, label):
    """One step's loss, aux and per-leaf gradients of ``cfg`` (fp32, random
    weights from ``seed``) on the card against the port's CPU path."""
    from repro_torch.models.api import get_model

    state = {k: v.cpu() for k, v in
             seeded(torch, get_model(cfg, device="cuda"), seed).state_dict().items()}
    free_card(torch)
    t = time.perf_counter()
    card = train_grads(torch, cfg, state, batch, "cuda")
    card_s = time.perf_counter() - t
    free_card(torch)
    cpu = train_grads(torch, cfg, state, batch, "cpu")
    scale = max(float(g.abs().max()) for g in cpu[2].values())
    worst = max((float((card[2][k] - g).abs().max()), k) for k, g in cpu[2].items())
    rec = {"loss_card": card[0], "loss_cpu": cpu[0],
           "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
           "aux_card": card[1], "aux_cpu": cpu[1], "grad_max_abs_err": worst[0],
           "grad_worst_leaf": worst[1], "grad_scale": scale,
           "grad_err_of_scale": worst[0] / scale, "leaves": len(cpu[2]),
           "card_step_s": card_s}
    if rec["loss_rel_err"] > LOSS_RTOL:
        raise AssertionError(f"train {label}: card loss {card[0]} vs CPU {cpu[0]}")
    if abs(card[1] - cpu[1]) > LOSS_RTOL * max(abs(cpu[1]), 1e-30):
        raise AssertionError(f"train {label}: card aux {card[1]} vs CPU {cpu[1]}")
    if worst[0] > GRAD_TOL * scale:
        raise AssertionError(f"train {label}: gradient of {worst[1]} off by {worst[0]:.3e} "
                             f"> {GRAD_TOL} x {scale:.3e}")
    return rec, state, cpu[2]


def optimizer_card_vs_cpu(torch, cfg, state, grads):
    """AdamW and Adafactor on identical inputs: the parameters, gradients
    and the state after one CPU update from zeros, then one update on the
    card and one on the CPU.  The updates (float32 arithmetic) are held to
    ``OPT_TOL``; Adafactor's bf16 first moment may differ by a rounding
    step where its float32 value sits on a boundary: counted.  Every leaf
    but the embedding, whose 155.6 M entries take the CPU side most of the
    time and run the code of every other 2-D leaf (PERF.md §4)."""
    from repro_torch.config import TrainConfig
    from repro_torch.models.bridge import reference_stacks
    from repro_torch.train.optimizer import OPTIMIZERS

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    stacks = [g for g in reference_stacks(state, cfg) if g != ["embed"]]
    state = {k: p for k, p in state.items() if k != "embed"}
    grads = {k: g for k, g in grads.items() if k != "embed"}
    half = {k: 0.5 * g for k, g in grads.items()}
    out = {}
    for name, (init, update) in OPTIMIZERS.items():
        _, state1 = update(grads, init(state), state, 0, tc, stacks)
        res = {}
        for dev in ("cpu", "cuda"):
            u, st = update({k: g.to(dev) for k, g in half.items()},
                           tree_to(state1, dev), {k: p.to(dev) for k, p in state.items()},
                           1, tc, stacks)
            res[dev] = ({k: v.cpu() for k, v in u.items()},
                        {k: v.cpu() for k, v in st["m"].items()})
            del u, st
        worst = max(float((res["cuda"][0][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    for k, w in res["cpu"][0].items())
        if worst > OPT_TOL:
            raise AssertionError(f"train: {name} update on the card off the CPU's by {worst:.3e}"
                                 f" of a leaf's largest entry > {OPT_TOL}")
        m_cpu, m_card = res["cpu"][1], res["cuda"][1]
        out[name] = {"update_err_of_scale": worst,
                     "m_entries_equal": [sum(int((m_card[k] == m).sum()) for k, m in m_cpu.items()),
                                         sum(m.numel() for m in m_cpu.values())]}
        del state1, res
    free_card(torch)
    return out


def tree_to(tree, dev):
    """A nested dict of tensors on ``dev``."""
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def resume_on_card(torch, cfg, src):
    """6 steps in one run (a checkpoint saved after step 3) against a fresh
    Trainer resumed from that checkpoint and 3 more steps (AdamW), all on
    the card."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import TrainConfig
    from repro_torch.data import make_batches
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6, checkpoint_every=3)

    def trainer(seed, ck=None):
        return Trainer(get_model(cfg, device="cuda"), tc,
                       generator=torch.Generator(device="cuda").manual_seed(seed),
                       ckpt_manager=ck)

    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2, fingerprint=cfg.name)
        whole = trainer(0, ck)
        batches = make_batches(src)
        whole.train(batches, 3, log_every=3)  # saves step 3
        whole.ckpt = None
        whole.train(batches, 3, log_every=3)
        batches.close()
        want = {k: p.detach().cpu() for k, p in whole.params.items()}
        del whole
        again = trainer(1, ck)  # other weights, overwritten by the checkpoint
        if not again.maybe_resume() or again.step != 3:
            raise AssertionError("train: the fresh Trainer did not resume at step 3")
        again.ckpt = None  # nothing more to save
        again.train(make_batches(src, start_step=3), 3, log_every=3)
        got = {k: p.detach().cpu() for k, p in again.params.items()}
        del again
    free_card(torch)
    worst = max(float(((got[k] - w).abs() / (RESUME_TOL + RESUME_TOL * w.abs())).max())
                for k, w in want.items())
    if worst > 1.0:
        raise AssertionError(f"train: resumed parameters off the one-run ones ({worst:.3f} "
                             f"of rtol = atol = {RESUME_TOL})")
    return {"leaves": len(want), "bitwise_equal_leaves": sum(torch.equal(got[k], w)
                                                              for k, w in want.items()),
            "worst_of_tolerance": worst}


def train_full_width(torch, card, *, steps=TRAIN_STEPS):
    """3j (b): qwen3-0.6b, all 28 layers, bf16, AdamW, remat "full", batch
    8 x 512 from the synthetic pipeline, ``steps`` steps at lr 1e-3 with 3
    warmup steps (``launch.train``'s schedule); each step timed to a
    synchronize."""
    from repro_torch.benchmarks.kernels import BF16_FLOPS
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, make_batches
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer

    cfg = get_config("qwen3-0.6b")
    B, S = 8, 512
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(get_model(cfg, device="cuda"),
                      TrainConfig(learning_rate=1e-3, warmup_steps=3, total_steps=steps),
                      generator=torch.Generator(device="cuda").manual_seed(0))
    n_params = trainer.model.param_count()
    times = []
    step_fn = trainer._step_fn

    def timed(*a):
        t = time.perf_counter()
        out = step_fn(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    trainer._step_fn = timed
    batches = make_batches(SyntheticTokens(cfg, batch=B, seq_len=S, seed=0))
    hist = trainer.train(batches, steps, log_every=1)
    batches.close()
    peak = torch.cuda.max_memory_allocated()
    del trainer
    free_card(torch)
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite bf16 loss {losses}")
    if not losses[-1] < losses[0] - 1.0:
        raise AssertionError(f"train: bf16 loss {losses[0]:.4f} -> {losses[-1]:.4f}, a drop "
                             "of no more than 1.0")
    step_s = statistics.median(times[3:])
    tokens = B * S
    return {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.param_dtype,
            "remat": cfg.remat_policy, "optimizer": "adamw", "batch": [B, S],
            "steps": steps, "params": n_params, "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses, "step_ms_median": step_s * 1e3,
            "step_ms": [t * 1e3 for t in times], "tokens_per_s": tokens / step_s,
            "peak_memory_gb": peak / 1e9,
            "model_flop_share": 6 * n_params * tokens / step_s / BF16_FLOPS,
            "model_flop_share_note": (
                "6 x params x tokens a step over the step time over the H100 SXM's "
                "dense bf16 peak of 989 TFLOP/s (NVIDIA data sheet); full remat runs "
                "more FLOPs than this counts"),
            "card": card}


def train_mini_phase(torch):
    """3j (d): ``python -m repro_torch.examples.train_mini`` at its defaults
    but ``--steps`` (``TRAIN_MINI_STEPS``)."""
    from repro_torch.examples import train_mini

    t = time.perf_counter()
    res, lines = run_example(train_mini.main, ["--steps", str(TRAIN_MINI_STEPS)])
    wall = time.perf_counter() - t
    free_card(torch)
    for line in lines:
        if line.strip():
            log(f"[train] train_mini: {line}")
    # the last checkpoint of the first half (the reference's arithmetic)
    every, half = TRAIN_MINI_STEPS // 3, TRAIN_MINI_STEPS // 2
    want_resume = half // every * every
    if f"resumed at step {want_resume}" not in lines or res["resumed_at"] != want_resume:
        raise AssertionError(f"train: train_mini did not resume at step {want_resume}")
    if not res["ok"] or not lines[-1].endswith("(OK)"):
        raise AssertionError(f"train: train_mini's verdict: {lines[-1]}")
    return {"steps": TRAIN_MINI_STEPS, "resumed_at": res["resumed_at"],
            "step_ms_median": statistics.median(
                1e3 * (b["wall"] - a["wall"]) / (b["step"] - a["step"])
                for h in (res["history"], res["history_resumed"])
                for a, b in zip(h, h[1:])),
            "loss_first": res["history"][0]["loss"],
            "loss_last": res["history_resumed"][-1]["loss"], "verdict": "OK", "wall_s": wall}


def train_phase(torch, card):
    """Phase 3j: single-device training (``repro_torch.train``), K1-K4
    launch counters zeroed before and asserted 0 after (training runs the
    plain attention and scans: the kernels have no backward).  (a) fp32
    qwen3-0.6b at full width and ``TRAIN_PARITY_LAYERS`` layers: one step's
    loss and gradients card = CPU, AdamW and Adafactor updates card = CPU,
    6 steps = 3 + checkpoint + resumed 3; (b) bf16 at all 28 layers, 30
    steps, the loss drop and the step's time, rate, memory and model-FLOP
    share; (c) deepseek-moe-16b fp32 at full width, 2 layers (dense0 and
    one moe layer): loss, aux and gradients card = CPU; (d) train_mini."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.data.pipeline import as_tensors

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("train: fp32 parity needs TF32 off")
    t0 = time.perf_counter()
    zero_counters()
    out = {"card": card}
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    cfg = get_config("qwen3-0.6b").replace(num_layers=TRAIN_PARITY_LAYERS, **f32)
    src = SyntheticTokens(cfg, batch=2, seq_len=64, seed=0)
    part_s = out["part_s"] = {}

    def lap(name, t):
        part_s[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    rec, state, grads = card_vs_cpu(torch, cfg, 0, as_tensors(src.batch_at(0)), "qwen3 fp32")
    t = lap("a_grads", t)
    rec["optimizer"] = optimizer_card_vs_cpu(torch, cfg, state, grads)
    del state, grads
    t = lap("a_optimizer", t)
    rec["resume"] = resume_on_card(torch, cfg, src)
    t = lap("a_resume", t)
    out["parity_fp32"] = {"model": cfg.name, "layers": cfg.num_layers, "batch": [2, 64], **rec}
    log(f"[train] (a) qwen3-0.6b fp32 x{cfg.num_layers}: loss card {rec['loss_card']:.7f} "
        f"CPU {rec['loss_cpu']:.7f}; worst gradient {rec['grad_err_of_scale']:.2e} of the "
        f"largest; optimizer {rec['optimizer']}; 6 steps = 3 + resume + 3, "
        f"{rec['resume']['bitwise_equal_leaves']} of {rec['resume']['leaves']} leaves bitwise")
    out["bf16_full"] = train_full_width(torch, card)
    t = lap("b", t)
    b = out["bf16_full"]
    log(f"[train] (b) qwen3-0.6b {b['dtype']} x{b['layers']}, 8 x 512, {b['steps']} steps: loss "
        f"{b['loss_first']:.4f} -> {b['loss_last']:.4f}; step {b['step_ms_median']:.1f} ms "
        f"(median after step 3), {b['tokens_per_s']:.0f} tokens/s, peak "
        f"{b['peak_memory_gb']:.2f} GB, model-FLOP share {b['model_flop_share']:.4f}")
    moe_cfg = get_config("deepseek-moe-16b").replace(num_layers=2, **f32)
    moe_src = SyntheticTokens(moe_cfg, batch=2, seq_len=64, seed=0)
    rec, _, _ = card_vs_cpu(torch, moe_cfg, 0, as_tensors(moe_src.batch_at(0)), "deepseek fp32")
    out["moe_parity"] = {"model": moe_cfg.name, "layers": 2, "batch": [2, 64], **rec}
    free_card(torch)
    t = lap("c", t)
    log(f"[train] (c) deepseek-moe-16b fp32 x2: loss card {rec['loss_card']:.7f} CPU "
        f"{rec['loss_cpu']:.7f}, aux {rec['aux_card']:.7f} / {rec['aux_cpu']:.7f}; worst "
        f"gradient {rec['grad_err_of_scale']:.2e} of the largest")
    out["train_mini"] = train_mini_phase(torch)
    lap("d", t)
    launched = counters()
    out["kernel_launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"train: a kernel launched during training: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"train": out}))
    return out


# ---------------------------------------------------------------------------
# phase 3k: multi-device training's path on a world of one
# ---------------------------------------------------------------------------

MESH_LAYERS = TRAIN_PARITY_LAYERS  # 3k: qwen3-0.6b fp32 at full width, this deep


def _same(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def mesh_train_phase(torch, card):
    """Phase 3k: the sharded training path (``ShardingContext`` on a
    ``DeviceMesh``, DTensor parameters, ZeRO) on a world-of-one ``nccl``
    group and a 1 x 1 data x model mesh, K1-K4 counters zeroed before and
    asserted 0 after.  (a) qwen3-0.6b fp32 at full width and
    ``MESH_LAYERS`` layers: loss and gradients through the DTensor path
    bitwise equal to the no-context path's, then one ZeRO AdamW step
    bitwise equal to the single-device step (parameters and moments);
    (b) ``int8_allreduce_mean`` over the mesh's data axis bitwise its numpy
    oracle.  No fallback: a failed ``nccl`` start or collective fails the
    script."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.distributed.collectives import int8_allreduce_mean
    from repro_torch.distributed.sharding import (ShardingContext, activate, distribute_params,
                                                  full_tensor as full)
    from repro_torch.launch.mesh import free_port
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import trainable, value_and_grad

    t0 = time.perf_counter()
    zero_counters()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    out = {"card": card, "backend": dist.get_backend(), "world": dist.get_world_size()}
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config("qwen3-0.6b").replace(num_layers=MESH_LAYERS, param_dtype="float32",
                                               activation_dtype="float32")
        ctx = ShardingContext.for_arch(cfg, mesh)
        src = SyntheticTokens(cfg, batch=2, seq_len=64, seed=0)
        batch = {k: v.to("cuda") for k, v in as_tensors(src.batch_at(0)).items()}

        def model():
            return seeded(torch, get_model(cfg, device="cuda"), 0)

        plain = model()
        l0, _, g0 = value_and_grad(plain, trainable(plain), batch)
        del plain
        sharded = model()
        t = time.perf_counter()
        with activate(ctx):
            distribute_params(sharded, ctx)
            l1, _, g1 = value_and_grad(
                sharded, trainable(sharded),
                {k: ctx.distribute(v, ("batch", None)) for k, v in batch.items()})
            g1 = {k: full(g) for k, g in g1.items()}
            l1 = full(l1)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t
        del sharded
        unequal = [k for k in g0 if not _same(torch, g0[k], g1[k])]
        if not _same(torch, l0, l1) or unequal:
            raise AssertionError(f"mesh: 1 x 1 loss {float(l1)} vs {float(l0)}, gradients "
                                 f"not bitwise: {unequal[:5]}")
        out["grads"] = {"loss": float(l0), "leaves": len(g0), "bitwise_equal_leaves": len(g0),
                        "mesh_grad_s": grad_s}
        del g0, g1
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
        one = Trainer(model(), tc)
        h0 = one.train(iter([src.batch_at(1)]), 1, log_every=1)
        with activate(ctx):
            two = Trainer(model(), tc)
            h1 = two.train(iter([src.batch_at(1)]), 1, log_every=1)
            p1 = {k: full(p.detach()) for k, p in two.params.items()}
            m1 = {part: {k: full(v) for k, v in two.opt_state[part].items()}
                  for part in ("m", "v")}
        bad = [k for k, p in one.params.items() if not _same(torch, p.detach(), p1[k])]
        bad += [f"{part}/{k}" for part in ("m", "v") for k, v in one.opt_state[part].items()
                if not _same(torch, v, m1[part][k])]
        if bad or h0[0]["loss"] != h1[0]["loss"] or h0[0]["grad_norm"] != h1[0]["grad_norm"]:
            raise AssertionError(f"mesh: the 1 x 1 ZeRO AdamW step is not the single-device "
                                 f"step bit for bit: {bad[:5]}, {h0} vs {h1}")
        out["zero_step"] = {"loss": h0[0]["loss"], "grad_norm": h0[0]["grad_norm"],
                            "bitwise_equal_leaves": len(p1) + 2 * len(p1)}
        del one, two, p1, m1
        free_card(torch)
        rng = np.random.default_rng(7)
        g = rng.standard_normal((1024, 1024)).astype(np.float32)
        got = int8_allreduce_mean({"g": torch.from_numpy(g).cuda()}, mesh, ("data",))["g"]
        scale = np.float32(np.abs(g).max()) / np.float32(127.0) + np.float32(1e-12)
        q = np.clip(np.rint(g / scale), -127, 127).astype(np.int8).astype(np.int32)
        want = (q.astype(np.float32) * scale / np.float32(1)).astype(np.float32)
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError("mesh: int8_allreduce_mean on the card off its numpy oracle")
        out["int8_allreduce_mean"] = {"shape": [1024, 1024], "bitwise_equal_to_oracle": True}
    finally:
        dist.destroy_process_group()
    launched = counters()
    out["kernel_launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"mesh: a kernel launched on the sharded training path: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[mesh] (a) qwen3-0.6b fp32 x{MESH_LAYERS} on a 1 x 1 nccl mesh: loss "
        f"{out['grads']['loss']:.7f} and {out['grads']['leaves']} gradients bitwise = no "
        f"context; ZeRO AdamW step bitwise = one device; (b) int8_allreduce_mean = numpy "
        f"oracle; K1-K4 0; {out['seconds']:.1f} s")
    log(json.dumps({"mesh_train": out}))
    return out


# ---------------------------------------------------------------------------
# phase 3l: the dry run and the roofline
# ---------------------------------------------------------------------------

# 3l (a): run_cell on the fake 16 x 16 world (fake cuda tensors)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
                ("qwen3-0.6b", "decode_32k"), ("rwkv6-7b", "prefill_32k"),
                ("zamba2-7b", "prefill_32k"))
# 3l (b): qwen3-0.6b cells run for real on the one card, each global batch
# cut to fit its 80 GB (PERF.md §4): decode_32k 128 -> 8 rows (a bf16 KV
# cache of 8 x 32,768 x 114,688 B = 30.1 GB), prefill_32k 32 -> 1
DRYRUN_REAL = {"decode_32k": 8, "prefill_32k": 1}
DRYRUN_ARCH = "qwen3-0.6b"
DRYRUN_TIMED = 5  # timed steps per cell, after one warm-up
DRYRUN_BOUND_SLACK = 1.05  # t_bound / t_step above this: the count is wrong
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_smoke")
DRYRUN_WAIT_S = 900  # the fake traces' process, joined at 3l
# 3l (b)'s no-context check in float32, where the two paths may differ by
# their GEMMs' summation order only: qwen3-0.6b at full width, the cells
# cut to a 4,096-token cache / prompt.  In bf16 at random weights that
# order alone moved a decode's logits by 0.203 on one H100 (PERF.md §6):
# the bf16 cells' difference is recorded, not asserted.
DRYRUN_F32 = {"decode_32k": (8, 4096), "prefill_32k": (1, 4096)}


def dryrun_real_shapes():
    from repro_torch.config import SHAPES_BY_NAME, ShapeConfig

    return {name: ShapeConfig(name, SHAPES_BY_NAME[name].seq_len, batch,
                              SHAPES_BY_NAME[name].kind)
            for name, batch in DRYRUN_REAL.items()}


def dryrun_traces(out_path: str) -> None:
    """3l's fake traces, run in a process of their own that ``main`` starts
    first, so that they overlap the card's phases (they need the host, not
    the card): (a) ``launch.dryrun.run_cell`` for ``DRYRUN_CELLS`` on the
    fake 16 x 16 world with fake cuda tensors (the kernels' custom ops count
    their work and launch nothing: K1-K4 must stay at 0); (b) the fake
    traces of 3l (b)'s cut cells on a fake world of one.  Writes a JSON
    summary to ``out_path``; raises on any failure."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import start_fake_world

    torch.set_num_threads(1)  # leave the host's cores to the card's phases,
    os.nice(19)  # and their turn first (their times are measured)
    zero_counters()
    res = {"cells": {}, "real_cells": {}}
    for arch, shape in DRYRUN_CELLS:
        t = time.perf_counter()
        art = run_cell(arch, shape, out_dir=DRYRUN_DIR, verbose=False)
        r = art["roofline"]
        res["cells"][f"{arch}|{shape}"] = {
            "ok": art["ok"], "seconds": time.perf_counter() - t,
            "flops_per_chip": art["hlo_flops_per_chip"],
            "resident_bytes_per_chip": art["resident_bytes_per_chip"],
            "bottleneck": r["bottleneck"], "t_bound_s": max(r["t_compute_s"], r["t_memory_s"],
                                                            r["t_collective_s"]),
            "roofline_fraction": r["roofline_fraction"], "wire_GB": art["collectives"]["wire_GB"]}
    res["kernel_launches"] = counters()
    start_fake_world(1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config(DRYRUN_ARCH)
    for name, shape in dryrun_real_shapes().items():
        c = build_cell(cfg, shape, mesh).lower(mesh, "cuda")
        res["real_cells"][name] = {"flops": c.total_flops(), "bytes": c.total_traffic_bytes(),
                                   "collectives": c.collective_stats().summary()}
    res["kernel_launches_real_cells_fake"] = counters()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def start_dryrun_traces():
    """Start :func:`dryrun_traces` in a child process; returns (process,
    JSON path, log path)."""
    import subprocess

    os.makedirs(DRYRUN_DIR, exist_ok=True)
    out = os.path.join(DRYRUN_DIR, "traces.json")
    log_path = os.path.join(DRYRUN_DIR, "traces.log")
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.environ.get("PYTHONPATH", "")]))
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c",
                                 f"import chip_smoke as cs; cs.dryrun_traces({out!r})"],
                                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log_path


def _local_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a DTensor's local block)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def plain_twin(torch, cfg, model, args):
    """``model`` and ``args`` (DTensors on a 1 x 1 mesh) as plain tensors:
    a model on the same weights and the same inputs for the no-context
    path (no copy: a 1 x 1 DTensor's local block is the whole tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.api import get_model

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(plain(v) for v in tree)
        return tree.to_local() if isinstance(tree, DTensor) else tree

    twin = get_model(cfg, device="meta")
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = twin.get_submodule(owner) if owner else twin
        mod._parameters[leaf] = torch.nn.Parameter(plain(p.detach()), requires_grad=False)
    return twin, plain(args)


def no_context_diff(torch, cell, ctx, model, args, tol: float) -> dict:
    """The step's logits on the mesh against the same step with no context
    on the same weights and inputs (:func:`plain_twin`): max abs and
    relative (to the largest |logit|) difference, whether every logit is
    within ``tol`` abs + rel, bitwise or not, and the rows whose argmax
    agrees."""
    from repro_torch.distributed.sharding import activate

    with activate(ctx):
        mesh_logits = cell.step(model, *args)[0].to_local()
    twin, plain_args = plain_twin(torch, cell.arch, model, args)
    plain_logits = cell.step(twin, *plain_args)[0]
    torch.cuda.synchronize()
    if mesh_logits.shape != plain_logits.shape:
        raise AssertionError(f"3l (b): logits {tuple(mesh_logits.shape)} on the mesh, "
                             f"{tuple(plain_logits.shape)} with no context")
    a, b = mesh_logits.float(), plain_logits.float()
    err = float((a - b).abs().max())
    return {"max_abs_err": err, "rel_err": err / max(float(b.abs().max()), 1e-30),
            "tol": tol, "within_tol": bool(torch.allclose(a, b, atol=tol, rtol=tol)),
            "bitwise": _same(torch, mesh_logits, plain_logits),
            "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum()), "rows": a.shape[0]}


def dryrun_f32_check(torch, mesh) -> dict:
    """3l (b)'s asserted no-context check: ``DRYRUN_F32``'s float32 cells,
    each step's logits within ``TOL["float32"]`` of the no-context path's."""
    from repro_torch.config import SHAPES_BY_NAME, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell

    cfg = get_config(DRYRUN_ARCH).replace(param_dtype="float32", activation_dtype="float32")
    tol, out = TOL["float32"], {}
    for seed, (name, (batch, seq)) in enumerate(DRYRUN_F32.items()):
        shape = ShapeConfig(f"{name}_f32", seq, batch, SHAPES_BY_NAME[name].kind)
        cell = build_cell(cfg, shape, mesh)
        g = torch.Generator(device="cuda").manual_seed(200 + seed)
        model, args = cell.materialize("cuda", mesh, generator=g)
        d = no_context_diff(torch, cell, cell.context(mesh), model, args, tol)
        if not d["within_tol"]:
            raise AssertionError(f"3l (b) {shape.name}: the mesh step's float32 logits differ "
                                 f"from the no-context path's by {d['max_abs_err']:.3e} "
                                 f"(tol {tol} abs + rel)")
        out[shape.name] = d
        log(f"[dryrun] (b) {shape.name} B={batch} S={seq} float32: logits vs the no-context "
            f"path max abs err {d['max_abs_err']:.3e}{' (bitwise)' if d['bitwise'] else ''}, "
            f"argmax {d['argmax_agree']}/{d['rows']}")
        del model, args
        free_card(torch)
    return out


def dryrun_phase(torch, card, traces):
    """Phase 3l: the dry run and the roofline tooling.  (a) joins the fake
    traces' process (:func:`dryrun_traces`): every cell ``ok``, K1-K4
    launched 0 times there.  (b) qwen3-0.6b's cut cells (``DRYRUN_REAL``)
    for real on a world-of-one ``nccl`` group and a 1 x 1 mesh, bf16
    random weights from a seeded generator: the counter's FLOPs and bytes
    of the real step exactly those of its fake trace, the resident bytes
    the real inputs' bytes, the prefill launching K2 once per layer, and
    the step's median time at least the report's ``t_bound`` (a ratio past
    ``DRYRUN_BOUND_SLACK`` fails: the count is wrong); each step's logits
    against the no-context path on the same weights and inputs, recorded
    in bf16 and held to ``TOL["float32"]`` in :func:`dryrun_f32_check`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activate
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import free_port
    from repro_torch.roofline.analysis import build_report
    from repro_torch.roofline.opcount import OpCounter
    from repro_torch.roofline.structural import structural_bytes

    t0 = time.perf_counter()
    proc, out_path, log_path = traces
    rc = proc.wait(timeout=DRYRUN_WAIT_S)
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"3l (a): the fake traces failed (exit {rc}):\n{tail}")
    with open(out_path) as f:
        fake = json.load(f)
    wait_s = time.perf_counter() - t0
    bad = [k for k, v in fake["cells"].items() if not v["ok"]]
    if bad or len(fake["cells"]) != len(DRYRUN_CELLS):
        raise AssertionError(f"3l (a): cells not ok: {bad}")
    for key in ("kernel_launches", "kernel_launches_real_cells_fake"):
        if any(fake[key].values()):
            raise AssertionError(f"3l (a): a kernel launched on a fake trace: {fake[key]}")
    for k, v in fake["cells"].items():
        log(f"[dryrun] (a) {k} 16x16 fake cuda: ok in {v['seconds']:.1f} s, "
            f"{v['flops_per_chip']:.4e} FLOPs/chip, resident {v['resident_bytes_per_chip']}"
            f" B/chip, bound by {v['bottleneck']} ({v['t_bound_s']:.4e} s)")
    out = {"card": card, "fake_cells": fake["cells"], "fake_wait_s": wait_s,
           "kernel_launches_fake": fake["kernel_launches"], "real": {}}

    cfg = get_config(DRYRUN_ARCH)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for seed, (name, shape) in enumerate(dryrun_real_shapes().items()):
            cell = build_cell(cfg, shape, mesh)
            ctx = cell.context(mesh)
            g = torch.Generator(device="cuda").manual_seed(100 + seed)
            model, args = cell.materialize("cuda", mesh, generator=g)
            real_bytes = _local_bytes(args)
            if real_bytes != cell.resident_bytes_per_chip():
                raise AssertionError(f"3l (b) {name}: resident_bytes_per_chip "
                                     f"{cell.resident_bytes_per_chip()} != the real inputs' "
                                     f"{real_bytes} B")
            zero_counters()
            with activate(ctx):
                with OpCounter() as c:
                    res = cell.step(model, *args)
                del res
            torch.cuda.synchronize()
            launched = counters()
            want = fake["real_cells"][name]
            if (c.total_flops(), c.total_traffic_bytes()) != (want["flops"], want["bytes"]):
                raise AssertionError(f"3l (b) {name}: the real step counts "
                                     f"{c.total_flops()} FLOPs / {c.total_traffic_bytes()} B, "
                                     f"its fake trace {want['flops']} / {want['bytes']}")
            k2 = cfg.num_layers if shape.kind == "prefill" else 0
            want_l = {k: 0 for k in launched}
            want_l["flash_prefill"] = k2
            if launched != want_l:
                raise AssertionError(f"3l (b) {name}: launches {launched} != {want_l}")
            times = []
            with activate(ctx):
                for i in range(DRYRUN_TIMED + 1):
                    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    s.record()
                    res = cell.step(model, *args)
                    e.record()
                    torch.cuda.synchronize()
                    del res
                    if i:
                        times.append(s.elapsed_time(e) / 1e3)
            t_step = statistics.median(times)
            no_ctx = no_context_diff(torch, cell, ctx, model, args, TOL[cfg.activation_dtype])
            report = build_report(cfg, shape, "1x1", 1, flops_per_chip=c.total_flops(),
                                  bytes_per_chip=structural_bytes(cfg, shape, mesh)["total"],
                                  collectives=c.collective_stats(),
                                  memory_per_chip=cell.resident_bytes_per_chip())
            ratio = report.t_bound / t_step
            row = {"shape": name, "global_batch": shape.global_batch,
                   "seq_len": shape.seq_len, "flops": c.total_flops(),
                   "traffic_bytes": c.total_traffic_bytes(),
                   "structural_bytes": report.hlo_bytes,
                   "resident_bytes": real_bytes, "kernel_launches": launched,
                   "t_compute_s": report.t_compute, "t_memory_s": report.t_memory,
                   "t_collective_s": report.t_collective, "t_bound_s": report.t_bound,
                   "bottleneck": report.bottleneck, "t_step_s": t_step,
                   "t_step_runs_s": times, "t_bound_over_t_step": ratio,
                   "mfu": report.mfu(t_step), "model_flops": report.model_flops_global,
                   "useful_flops_ratio": report.useful_flops_ratio,
                   "logits_vs_no_context": no_ctx}
            out["real"][name] = row
            log(f"[dryrun] (b) {DRYRUN_ARCH} {name} B={shape.global_batch} on the card: "
                f"real = fake {c.total_flops():.6e} FLOPs and {c.total_traffic_bytes():.6e} B; "
                f"resident {real_bytes} B = cell's; K2 {launched['flash_prefill']}; "
                f"t_step {t_step * 1e3:.3f} ms, t_bound {report.t_bound * 1e3:.3f} ms "
                f"({report.bottleneck})")
            log(f"[dryrun] (b) {name}: mfu {row['mfu']:.4f}, t_bound / t_step {ratio:.4f}; "
                f"bf16 logits vs the no-context path: max abs err "
                f"{no_ctx['max_abs_err']:.3e} (rel {no_ctx['rel_err']:.3e})"
                f"{' (bitwise)' if no_ctx['bitwise'] else ''}, argmax "
                f"{no_ctx['argmax_agree']}/{no_ctx['rows']} (recorded)")
            if ratio > DRYRUN_BOUND_SLACK:
                raise AssertionError(f"3l (b) {name}: t_bound / t_step = {ratio:.4f} > "
                                     f"{DRYRUN_BOUND_SLACK}: the count is wrong")
            del model, args
            free_card(torch)
        out["f32_no_context"] = dryrun_f32_check(torch, mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"dryrun": out}))
    return out


# ---------------------------------------------------------------------------
# the contiguous paths: rwkv6-7b and zamba2-7b
# ---------------------------------------------------------------------------

SSM_KERNEL = {"ssm": "rwkv6_scan", "hybrid": "mamba2_ssd"}
SSM_SLOTS, SSM_CAPACITY = 8, 1024  # 8 slots x 1024 tokens: zamba2's KV ~1.6 GB


def ssm_engine_config(tracing=False):
    from repro_torch.config import EngineConfig

    return EngineConfig(max_requests=SSM_SLOTS, max_batch_tokens=SSM_CAPACITY,
                        policy="neo", pipeline=False, hw_profile="h100_sxm", seed=0,
                        tracing=tracing)


def ssm_serve_phase(torch, cfg, device, *, n=8, tracing=False):
    """Serve ``n`` requests of ``cfg`` (ssm or hybrid) through the
    contiguous engine with every launch counter zeroed just before and read
    just after; the path's scan kernel must have launched once per layer per
    prefill and no other kernel at all.  Returns (summary, trace, tokens by
    request, the engine's tracer and stats)."""
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.request import RequestState
    from repro_torch.launch.serve import run_trace

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = NeoEngine(cfg, ssm_engine_config(tracing), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.paged:
        raise AssertionError(f"{cfg.name} took the paged path")
    trace = make_trace(n, cfg.vocab_size)
    calls = [0]
    prefill = engine.executor.prefill

    def counted(*a, **k):
        calls[0] += 1
        return prefill(*a, **k)

    engine.executor.prefill = counted
    zero_counters()
    m = run_trace(engine, trace, vocab=cfg.vocab_size)
    launched = counters()
    engine.close()
    done = [r for r in engine.requests.values() if r.state == RequestState.FINISHED]
    if len(done) != n:
        raise AssertionError(f"{cfg.name}: only {len(done)}/{n} requests finished")
    name = SSM_KERNEL[cfg.family]
    want = {k: 0 for k in launched}
    want[name] = cfg.num_layers * calls[0]
    want[name + "_stages"] = 3 * want[name]  # chunk states, state passing, chunk outputs
    if cfg.family == "hybrid":  # one shared-attention prefill per application
        want["flash_prefill"] = engine.model.n_attn_apps * calls[0]
    if launched != want or calls[0] != n:
        raise AssertionError(f"{cfg.name}: launches {launched} != {want} "
                             f"({cfg.num_layers} blocks x {calls[0]} prefills of {n} "
                             "requests)")
    s = engine.stats
    if cfg.family == "ssm" and (engine.scheduler.policy != "gpu_only"
                                or set(s.mode_counts) != {"gpu_only"}):
        raise AssertionError(f"{cfg.name}: scheduler ran {engine.scheduler.policy} "
                             f"{s.mode_counts}, the reference forces gpu_only")
    summary = {
        "model": cfg.name, "dtype": cfg.activation_dtype, "layers": cfg.num_layers,
        "params": engine.model.param_count(), "slots": engine.executor.slots,
        "capacity": engine.executor.capacity, "requests": len(m.finished),
        "prompt_tokens": sum(t.prompt_len for t in trace),
        "output_tok_s": m.throughput, "total_tok_s": m.token_throughput,
        "ttft_s": m.ttft(), "tpot_s": m.tpot(), "makespan_s": m.makespan,
        "iterations": s.iterations, "prefills": calls[0], "decode_rows": s.device_decodes,
        "lane_busy_s": dict(s.lane_busy_time), "plan_busy_s": s.plan_busy_time,
        "modes": s.mode_counts, "policy": engine.scheduler.policy,
        "kernel_launches": launched, "init_s": init_s,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "traced": tracing,
    }
    tokens = {rid: list(r.out_tokens) for rid, r in engine.requests.items()}
    tracer, stats = engine.tracer, engine.stats
    del engine
    gc.collect()  # the counting wrapper keeps the executor and its model in a cycle
    torch.cuda.empty_cache()
    return summary, trace, tokens, tracer, stats


def ssm_parity_phase(torch, cfg, device, trace):
    """The same requests in fp32 (TF32 off); every emitted token must be the
    oracle's argmax or within NEAR_TIE of its max logit.  The oracle is the
    engine's own model: a prefill of the prompt with the plain scan (and,
    for zamba2, the plain shared attention), then teacher-forced decode
    steps over the emitted tokens, one request at a time."""
    from repro_torch.core.engine import NeoEngine

    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    engine = NeoEngine(cfg32, ssm_engine_config(), device=device)
    rids = [engine.submit(t.prompt, t.output_len) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    model = engine.model
    exact = ties = total = 0
    worst_gap = 0.0
    for rid, t in zip(rids, trace):
        out = outs[rid]
        if len(out) != t.output_len:
            raise AssertionError(f"{cfg.name} parity engine: rid {rid} emitted {len(out)} tokens")
        logits, cache = model.prefill(torch.tensor([t.prompt]), capacity=SSM_CAPACITY,
                                      impl="plain")
        for i, got in enumerate(out):
            want = int(logits[0].argmax())
            gap = float(logits[0, want] - logits[0, got])
            total += 1
            if got == want:
                exact += 1
            elif gap <= NEAR_TIE:
                ties += 1
                worst_gap = max(worst_gap, gap)
            else:
                raise AssertionError(f"{cfg.name} parity: rid {rid} token {i}: engine {got}, "
                                     f"oracle {want}, logit gap {gap:.3e} > {NEAR_TIE}")
            if i + 1 < len(out):
                logits, cache = model.decode(torch.tensor([got]), cache)
    del engine, model, cache
    torch.cuda.empty_cache()
    return dict(model=cfg.name, tokens=total, exact=exact, near_ties=ties,
                worst_tie_gap=worst_gap)


def scan_entry(name, source, replaces, launched, t, shape, train_launched, mesh_launched,
               dryrun_launched):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[name], "stage_launches": launched[name + "_stages"],
            "launches_train_path": train_launched[name],
            "launches_mesh_train_path": mesh_launched[name],
            "launches_dryrun_path": dryrun_launched[name],
            "max_abs_err": t["max_abs_err"], "max_abs_err_sweep": t["max_abs_err_sweep"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "library_note": NO_LIBRARY, "shape": shape, "stages_ms": t["stages_ms"],
            "fp32": {k: t["fp32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "max_abs_err", "stages_ms")},
            "long": {k: t["long"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "max_abs_err", "stages_ms", "shape")},
            **({"heads_per_block_ms": t["heads_per_block_ms"]} if "heads_per_block_ms" in t
               else {})}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity: full float32 GEMMs
    torch.backends.cudnn.allow_tf32 = False

    # phase 3l (a)'s fake traces need the host only: they run beside the
    # card's phases, in a process of their own, joined at 3l
    traces = start_dryrun_traces()
    try:
        return run_phases(torch, t_start, traces)
    finally:
        if traces[0].poll() is None:
            traces[0].kill()
            traces[0].wait()


def run_phases(torch, t_start, traces) -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    def elapsed(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 1: setup ----------------------------------------------------
    card = card_line()
    log(card)
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    built = [src.name for src, text in logs.items() if text]
    log(f"[setup] built {', '.join(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, concurrently)")
    for src, text in logs.items():
        for line in text.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or ("spill" in line and " 0 bytes spill stores" not in line)):
                log(f"[setup] {src.name}: {line.strip()}")
    from repro_torch.kernels.flash_prefill.ops import smem_bytes as flash_smem
    from repro_torch.kernels.mamba2_ssd.ops import smem_bytes as ssd_smem
    from repro_torch.kernels.rwkv6_scan.ops import smem_bytes as rwkv_smem

    for src, fn in (("mamba2_ssd.cu", ssd_smem), ("rwkv6_scan.cu", rwkv_smem)):
        log(f"[setup] {src}: dynamic shared memory per block at N=64, stages 1 / 2 / 3: "
            + ", ".join(f"{dt}: " + " / ".join(str(fn(64, getattr(torch, dt), st))
                                                for st in (1, 2, 3))
                        for dt in ("bfloat16", "float32")) + " bytes (opted in)")
    log(f"[setup] flash_prefill.cu: dynamic shared memory per block "
        f"{flash_smem(128, torch.bfloat16)} bytes (bf16, tensor-core kernel) / "
        f"{flash_smem(128, torch.float32)} bytes (fp32, CUDA-core kernel) at hd=128 "
        "(opted in)")
    from repro_torch.kernels.paged_decode.ops import smem_bytes as decode_smem

    log(f"[setup] paged_decode.cu: dynamic shared memory per block "
        f"{decode_smem(128, 16, 2, torch.bfloat16)} bytes (bf16) / "
        f"{decode_smem(128, 16, 2, torch.float32)} bytes (fp32) at hd=128, page 16, "
        "qpk 2")

    # -- phase 2: kernels ----------------------------------------------------
    timed, worst = kernel_phase(torch)
    flash_t, flash_worst = flash_kernel_phase(torch)
    rwkv6_t, _ = rwkv6_kernel_phase(torch)
    ssd_t, _ = mamba2_kernel_phase(torch)
    spec_t, spec_decode_worst, spec_flash_worst = spec_kernel_phase(torch)
    p11_t, p11_decode_worst, p11_flash_worst = p11_kernel_phase(torch)
    elapsed("phase 2 (kernels)")
    for dt_name in ("float32", "bfloat16"):
        flash_worst[dt_name] = max(flash_worst[dt_name], spec_flash_worst[dt_name],
                                   p11_flash_worst[dt_name])
        worst[dt_name] = max(worst[dt_name], spec_decode_worst[dt_name],
                             p11_decode_worst[dt_name])

    # -- phase 3: serve each path --------------------------------------------
    cfg = get_config("qwen3-0.6b")
    serve_cfg = cfg.replace(num_layers=SERVE_LAYERS)
    serial, trace, m, launched, calls, shapes = serve_phase(serve_cfg, "cuda")
    log(json.dumps({"serve": {**serve_summary(serve_cfg, serial, m, launched, calls, card),
                              "prefill_shapes": shapes}}))
    # flash_prefill at the padded batch of the serve phase's first prefill call:
    # checked in fp32 and bf16, then timed
    B0, S0 = shapes[0]
    serve_case = dict(B=B0, S=S0, H=cfg.num_heads, KV=cfg.num_kv_heads, hd=cfg.head_dim,
                      causal=True, window=0)
    for dt_name, err in flash_sweep(torch, [serve_case], seed=300).items():
        flash_worst[dt_name] = max(flash_worst[dt_name], err)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flash_t["serve"] = flash_time(torch, flush, "first serve prefill", B0, S0,
                                  cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 0)
    del flush
    pipe, pipe_summary = pipelined_phase(serve_cfg, "cuda", serial, card)
    log(json.dumps({"serve": pipe_summary}))
    log(f"[serve] pipelined vs serial bf16 tokens: {pipe_summary['tokens_equal_to_serial']}"
        f" of {pipe_summary['tokens']} equal (asserted)")
    pipe_launched = pipe_summary["kernel_launches"]
    pipe_tokens = {rid: list(r.out_tokens) for rid, r in pipe.requests.items()}
    del serial, pipe
    torch.cuda.empty_cache()
    traced = traced_phase(serve_cfg, "cuda", pipe_tokens, pipe_summary["makespan_s"], card)
    log(json.dumps({"serve": traced}))
    log(f"[traced] {serve_cfg.name} pipelined: {traced['tokens_equal_to_untraced']} of "
        f"{traced['tokens']} tokens equal to the untraced phase's (asserted); "
        f"events recorded {traced['events_recorded']}, dropped 0; tracks "
        f"{','.join(traced['tracks'])}; makespan traced/untraced "
        f"{traced['makespan_ratio_traced_untraced']:.4f}; reconcile ok over "
        f"{traced['reconcile_checks']} checks; obs.validate ok (host lane, copy, adopts)")
    torch.cuda.empty_cache()
    log(json.dumps({"serve": online_phase(serve_cfg, "cuda", card)}))
    elapsed("phase 3/3b (serve, traced, open loop)")
    torch.cuda.empty_cache()
    prefix_a, prefix_b, _ = prefix_phase(torch, cfg, card)
    elapsed("phase 3c (prefix)")
    spec_a, _, spec_c, _ = spec_phase(torch, card)
    elapsed("phase 3d (spec)")
    p11 = p11_phase(torch, card)
    elapsed("phase 3e/3f (moe, vlm, audio)")
    tp_t, tp_a, tp_b, tp_c = tp_phase(torch, card)
    elapsed("phase 3g (tp)")
    _, bench_launches, _ = bench_phase(torch, card)
    elapsed("phase 3h (bench)")
    examples = examples_phase(torch, card)
    elapsed("phase 3i (examples)")
    train = train_phase(torch, card)
    elapsed("phase 3j (train)")
    mesh_train = mesh_train_phase(torch, card)
    elapsed("phase 3k (mesh train)")
    dryrun = dryrun_phase(torch, card, traces)
    elapsed("phase 3l (dry run)")
    for dt_name in ("float32", "bfloat16"):
        worst[dt_name] = max(worst[dt_name], tp_t[1][dt_name])
        flash_worst[dt_name] = max(flash_worst[dt_name], tp_t[2][dt_name])
    ssm = {}
    for arch in ("rwkv6-7b", "zamba2-7b"):
        summary, ssm_trace, tokens, _, _ = ssm_serve_phase(torch, get_config(arch), "cuda")
        ssm[arch] = (summary, ssm_trace, tokens)
        log(json.dumps({"serve": {**summary, "card": card}}))
    rwkv = get_config("rwkv6-7b")
    t_summary, _, t_tokens, t_tracer, t_stats = ssm_serve_phase(torch, rwkv, "cuda",
                                                                tracing=True)
    same, total, rep = check_traced("traced rwkv6-7b phase", t_tracer, t_stats, t_tokens,
                                    ssm["rwkv6-7b"][2])
    t_summary.update(tokens_equal_to_untraced=same, tokens=total,
                     events_recorded=t_tracer.total, events_dropped=t_tracer.dropped,
                     tracks=t_tracer.tracks(), reconcile_checks=len(rep.checks),
                     reconcile_ok=rep.ok, makespan_ratio_traced_untraced=(
                         t_summary["makespan_s"] / ssm["rwkv6-7b"][0]["makespan_s"]))
    log(json.dumps({"serve": {**t_summary, "card": card}}))
    log(f"[traced] {rwkv.name} contiguous: {same} of {total} tokens equal to the untraced "
        f"phase's (asserted); events recorded {t_tracer.total}; makespan traced/untraced "
        f"{t_summary['makespan_ratio_traced_untraced']:.4f}; reconcile ok over "
        f"{len(rep.checks)} checks")
    del t_tracer, t_stats
    busy = busy_share_phase(torch, cfg, "cuda", card)
    log(f"[busy] {cfg.name} pipelined, {busy['window_steps']} decode steps after prefill "
        f"({busy['window_wall_s']:.3f} s): kernels busy {busy['busy_share']:.4f} of the "
        f"window (idle {busy['idle_share']:.4f}), copies {busy['copy_busy_share']:.4f}; top 5: "
        + "; ".join(f"{k['name'][:60]} {k['total_ms']:.3f} ms x{k['launches']}"
                    for k in busy["top5_kernels"]))
    log(json.dumps({"busy_share": busy}))
    elapsed("phase 3 (ssm serve, traced rwkv6, busy share)")
    torch.cuda.empty_cache()

    from repro_torch.kernels.paged_decode.ops import PAGES_PER_SPLIT

    main_t = timed["main"]
    q_t = flash_t["qwen3"]
    log(json.dumps({"kernels": [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode/kernel.py:87",
        "launches": pipe_launched["paged_decode"],
        "merge_launches": pipe_launched["paged_decode_merge"],
        "launches_serial_path": launched["paged_decode"],
        "launches_prefix_path": prefix_b["kernel_launches"]["paged_decode"],
        "launches_spec_path": spec_a["ngram"]["kernel_launches"]["paged_decode"],
        "merge_launches_spec_path": spec_a["ngram"]["kernel_launches"]["paged_decode_merge"],
        "launches_spec_path_draft_model": spec_c["kernel_launches"]["paged_decode"],
        "launches_moe_path": p11["moe_pipelined"]["kernel_launches"]["paged_decode"],
        "launches_vlm_path": p11["vlm"]["kernel_launches"]["paged_decode"],
        "launches_tp_path": {f"qwen3-0.6b tp={tp}": tp_a[tp]["kernel_launches"]["paged_decode"]
                             for tp in (1, 2, 4)},
        "launches_tp_path_offload": tp_b["bf16_tp2"]["kernel_launches"]["paged_decode"],
        "launches_tp_path_qwen3_14b": tp_c[2]["kernel_launches"]["paged_decode"],
        "launches_bench_path": {k: v["paged_decode"] for k, v in bench_launches.items()},
        "launches_examples_path": {k: v["kernel_launches"]["paged_decode"]
                                   for k, v in examples.items()},
        "launches_train_path": train["kernel_launches"]["paged_decode"],
        "launches_mesh_train_path": mesh_train["kernel_launches"]["paged_decode"],
        "launches_dryrun_path": dryrun["kernel_launches_fake"]["paged_decode"],
        "launches_dryrun_real_decode": dryrun["real"]["decode_32k"]["kernel_launches"][
            "paged_decode"],
        "max_abs_err": main_t["max_abs_err"],
        "max_abs_err_sweep": worst,
        "ms": main_t["ms"],
        "kernel_ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shape": "B=8 H=16 KV=8 hd=128 page=16 bf16 sum(lens)=%d" % main_t["sum_lens"],
        "pages_per_split": PAGES_PER_SPLIT,
        "pages_per_split_ms": main_t["pages_per_split_ms"],
        "long": timed["long"],
        "qwen3_14b": spec_t["decode_qwen3_14b"],
        "deepseek_moe_16b": p11_t["decode_deepseek"],
        "internvl2_1b": p11_t["decode_internvl2"],
        "tp_shards": {k[len("decode_"):]: v for k, v in tp_t[0].items()
                      if k.startswith("decode_")},
    }, {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill/kernel.py:105",
        "launches": pipe_launched["flash_prefill"],
        "launches_serial_path": launched["flash_prefill"],
        "launches_prefix_path": prefix_b["kernel_launches"]["flash_prefill"],
        "launches_prefix_path_cache_off": prefix_a["kernel_launches"]["flash_prefill"],
        "launches_zamba2": ssm["zamba2-7b"][0]["kernel_launches"]["flash_prefill"],
        "launches_spec_path": spec_c["kernel_launches"]["flash_prefill"],
        "launches_spec_path_draft_prefills": spec_c["draft_prefills"],
        "launches_moe_path": p11["moe_pipelined"]["kernel_launches"]["flash_prefill"],
        "launches_vlm_path": p11["vlm"]["kernel_launches"]["flash_prefill"],
        "launches_audio_path": p11["audio"]["kernel_launches"]["flash_prefill"],
        "launches_tp_path": {f"qwen3-0.6b tp={tp}": tp_a[tp]["kernel_launches"]["flash_prefill"]
                             for tp in (1, 2, 4)},
        "launches_tp_path_offload": tp_b["bf16_tp2"]["kernel_launches"]["flash_prefill"],
        "launches_tp_path_qwen3_14b": tp_c[2]["kernel_launches"]["flash_prefill"],
        "launches_bench_path": {k: v["flash_prefill"] for k, v in bench_launches.items()},
        "launches_examples_path": {k: v["kernel_launches"]["flash_prefill"]
                                   for k, v in examples.items()},
        "launches_train_path": train["kernel_launches"]["flash_prefill"],
        "launches_mesh_train_path": mesh_train["kernel_launches"]["flash_prefill"],
        "launches_dryrun_path": dryrun["kernel_launches_fake"]["flash_prefill"],
        "launches_dryrun_real_prefill": dryrun["real"]["prefill_32k"]["kernel_launches"][
            "flash_prefill"],
        "max_abs_err": q_t["max_abs_err"],
        "max_abs_err_sweep": flash_worst,
        "ms": q_t["ms"],
        "kernel_ms": q_t["ms"],
        "plain_ms": q_t["plain_ms"],
        "bound_ms": q_t["bound_ms"],
        "bound_by": q_t["bound_by"],
        "library_ms": q_t["library_ms"],
        "shape": q_t["shape"],
        "fp32_kernel_ms": flash_t["qwen3_fp32"]["ms"],
        "fp32_plain_ms": flash_t["qwen3_fp32"]["plain_ms"],
        "fp32_bound_ms": flash_t["qwen3_fp32"]["bound_ms"],
        "other_shapes": {**{k: v for k, v in flash_t.items() if k != "qwen3"},
                         "qwen3_14b": spec_t["prefill_qwen3_14b"],
                         "draft_window": spec_t["prefill_draft_window"],
                         **{k[len("prefill_"):]: v for k, v in p11_t.items()
                            if k.startswith("prefill_")},
                         **{"tp_shard_" + k[len("prefill_"):]: v for k, v in tp_t[0].items()
                            if k.startswith("prefill_")}},
    }, scan_entry("rwkv6_scan", "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:91",
                  ssm["rwkv6-7b"][0]["kernel_launches"], rwkv6_t,
                  "B=1 T=512 H=64 N=64 bf16 r/k/v, f32 w/u/state",
                  train["kernel_launches"], mesh_train["kernel_launches"],
                  dryrun["kernel_launches_fake"]),
        scan_entry("mamba2_ssd", "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
                   "src/repro/kernels/mamba2_ssd/kernel.py:86",
                   ssm["zamba2-7b"][0]["kernel_launches"], ssd_t,
                   "B=1 T=512 H=112 P=64 N=64 bf16 x/B/C, f32 dt/A/D/state",
                   train["kernel_launches"], mesh_train["kernel_launches"],
                   dryrun["kernel_launches_fake"])]}))

    # -- phase 4: parity on the card -----------------------------------------
    for pipeline in (False, True):
        log(json.dumps({"parity": {**parity_phase(torch, serve_cfg, "cuda", trace,
                                                  pipeline=pipeline),
                                   "layers": serve_cfg.num_layers}}))
        torch.cuda.empty_cache()
    elapsed("phase 4 (qwen3-0.6b parity)")
    for arch, (_, ssm_trace, _) in ssm.items():
        ssm_cfg = get_config(arch).replace(num_layers=SSM_PARITY_LAYERS[arch])
        log(json.dumps({"parity": {**ssm_parity_phase(torch, ssm_cfg, "cuda", ssm_trace),
                                   "layers": ssm_cfg.num_layers}}))
    log(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
