#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:

1. setup   — versions, the card's name and power limit, build the CUDA
             kernel from the sources in this checkout;
2. kernel  — hold the paged decode kernel against its plain PyTorch version
             over a shape/length/dtype sweep; time kernel, plain version
             and a library yardstick (scaled_dot_product_attention on
             pre-gathered K/V, which the port never calls);
3. serve   — the port's main path: full-width qwen3-0.6b in bf16 (random
             weights from a seeded torch.Generator) served by NeoEngine
             through ``launch.serve.run_trace`` with a device pool small
             enough that the neo policy must offload; the kernel's launch
             counters (attention kernel, merge kernel) are zeroed just
             before and read just after;
4. parity  — the same engine in fp32 on the same prompts, every emitted
             token checked against the dense oracle (plain-torch prefill
             over prompt + out[:i]) on the card.

Output: the card line (nvidia-smi name, power limit), per-case kernel
lines, one ``{"kernels": [...]}`` line, the serve summary, the parity count
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {"float32": 2e-3, "bfloat16": 2e-2}  # tests/test_kernels.py tolerances
NEAR_TIE = 1e-3  # parity: a token within this of the oracle's max logit is a tie


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def time_ms(torch, fn, flush, iters=30, warmup=3):
    """Median device time of ``fn`` with L2 flushed before each launch (the
    main path finds each layer's pages cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def bound(q, lens, page, KV, hd):
    """Least time for the work this input needs: each needed K/V token, q,
    the output, lens and the needed block-table entries once; 4*H*hd FLOPs
    per token (f32 math, outside the tensor cores)."""
    el = q.element_size()
    B, H, _ = q.shape
    tok = sum(lens)
    nbytes = (tok * KV * hd * 2 * el + 2 * q.numel() * el + 4 * B
              + 4 * sum(-(-n // page) for n in lens))
    flops = 4 * H * hd * tok
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_call(torch, q, kp, vp, bt, ln, page):
    """scaled_dot_product_attention over K/V gathered ahead of time into a
    contiguous [B, KV, S, hd] tensor, with a length mask (yardstick only)."""
    import torch.nn.functional as F

    B, H, hd = q.shape
    KV = kp.shape[2]
    S = bt.shape[1] * page
    k = kp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
    v = vp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                  enable_gqa=True)


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

    # timings at the main path's shape (8 rows of the serve phase's lengths,
    # bf16, full-width qwen3-0.6b heads) and at a long-context decode shape
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = {}
    for label, B, lens in (("main", 8, [rng.randint(257, 800) for _ in range(8)]),
                           ("long", 64, [2048] * 64)):
        q, kp, vp, bt, ln = make_case(torch, B, 16, 8, 128, 16, lens, torch.bfloat16, seed=9)
        out = kern(q, kp, vp, bt, ln)
        err = float((out.float() - paged_decode_ref(q, kp, vp, bt, ln).float()).abs().max())
        t_k = time_ms(torch, lambda: kern(q, kp, vp, bt, ln), flush)
        t_p = time_ms(torch, lambda: paged_decode_ref(q, kp, vp, bt, ln), flush)
        t_l = time_ms(torch, library_call(torch, q, kp, vp, bt, ln, 16), flush)
        b_ms, b_by = bound(q, lens, 16, 8, 128)
        timed[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err, B=B, sum_lens=sum(lens))
        log(f"[kernel] timing {label}: B={B} H=16 KV=8 hd=128 bf16 sum(lens)={sum(lens)} "
            f"kernel={t_k:.4f} ms plain={t_p:.4f} ms library={t_l:.4f} ms "
            f"bound={b_ms:.4f} ms ({b_by}) max_abs_err={err:.3e}")
    return timed, worst


# ---------------------------------------------------------------------------
# phases 3 and 4: serve the main path, then parity against the oracle
# ---------------------------------------------------------------------------


def engine_config(device_pages, host_pages):
    from repro_torch.config import EngineConfig

    return EngineConfig(device_pool_pages=device_pages, host_pool_pages=host_pages,
                        policy="neo", pipeline=False, hw_profile="h100_sxm", seed=0)


def make_trace(n, vocab, seed=0):
    import numpy as np

    from repro_torch.serving.traces import TraceRequest

    rng = np.random.default_rng(seed)
    trace = [TraceRequest(0.0, int(rng.integers(256, 769)), 32) for _ in range(n)]
    for t in trace:
        t.materialise(rng, vocab)
    return trace


def serve_phase(cfg, device, *, n=8, device_pages=64, host_pages=512):
    """Serve ``n`` requests through the port's main path; returns the
    engine, the trace, the metrics, the attention and merge kernels'
    launches, and the decode calls."""
    from repro_torch.core.engine import NeoEngine
    from repro_torch.core.request import RequestState
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention
    from repro_torch.launch.serve import run_trace

    engine = NeoEngine(cfg, engine_config(device_pages, host_pages), device=device)
    trace = make_trace(n, cfg.vocab_size)
    calls = [0]
    decode = engine.executor.decode

    def counted(*a, **k):
        calls[0] += 1
        return decode(*a, **k)

    engine.executor.decode = counted
    paged_decode_attention.launches = 0
    paged_decode_attention.merge_launches = 0
    metrics = run_trace(engine, trace, vocab=cfg.vocab_size)
    launches = paged_decode_attention.launches
    merges = paged_decode_attention.merge_launches
    engine.close()
    done = [r for r in engine.requests.values() if r.state == RequestState.FINISHED]
    if len(done) != n:
        raise AssertionError(f"only {len(done)}/{n} requests finished")
    s = engine.stats
    if not (s.offloaded_decodes > 0 and s.device_decodes > 0 and engine.pool.swap_bytes > 0):
        raise AssertionError(f"main path did not split: offloaded={s.offloaded_decodes} "
                             f"device={s.device_decodes} swap_bytes={engine.pool.swap_bytes}")
    return engine, trace, metrics, launches, merges, calls[0]


def parity_phase(torch, cfg, device, trace, *, device_pages=64, host_pages=512, chunk=8):
    """fp32 engine on the same prompts; every emitted token must be the
    oracle's argmax or within NEAR_TIE of its max logit.  The oracle is the
    engine's own DenseLM run as a plain contiguous prefill over
    prompt + out[:i] (rows of one request batched with true_lens)."""
    from repro_torch.core.engine import NeoEngine

    cfg32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
    engine = NeoEngine(cfg32, engine_config(device_pages, host_pages), device=device)
    rids = [engine.submit(t.prompt, t.output_len) for t in trace]
    outs = engine.run_until_done(10_000)
    engine.close()
    exact = ties = total = 0
    worst_gap = 0.0
    for rid, t in zip(rids, trace):
        out = outs[rid]
        if len(out) != t.output_len:
            raise AssertionError(f"parity engine: rid {rid} emitted {len(out)} tokens")
        seqs = [t.prompt + out[:i] for i in range(len(out))]
        for c0 in range(0, len(seqs), chunk):
            rows = seqs[c0:c0 + chunk]
            S = max(map(len, rows))
            tok = torch.zeros(len(rows), S, dtype=torch.long)
            for j, r in enumerate(rows):
                tok[j, : len(r)] = torch.tensor(r)
            lens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
            logits, _ = engine.model.prefill(tok, true_lens=lens)
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
    return dict(tokens=total, exact=exact, near_ties=ties, worst_tie_gap=worst_gap,
                offloaded_decodes=engine.stats.offloaded_decodes,
                device_decodes=engine.stats.device_decodes)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity: full float32 GEMMs
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_decode.ops import SOURCE

    # -- phase 1: setup ----------------------------------------------------
    card = card_line()
    log(card)
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    text = _build.build(SOURCE)
    log(f"[setup] built {SOURCE.name if text else 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            log(f"[setup] {SOURCE.name}: {line.strip()}")

    # -- phase 2: kernel -----------------------------------------------------
    timed, worst = kernel_phase(torch)

    # -- phase 3: serve (the main path) --------------------------------------
    cfg = get_config("qwen3-0.6b")
    engine, trace, m, launches, merges, calls = serve_phase(cfg, "cuda")
    if launches != cfg.num_layers * calls or calls == 0:
        raise AssertionError(f"kernel launches {launches} != {cfg.num_layers} x "
                             f"{calls} decode calls")
    if not 0 < merges <= launches:  # the main path's rows are long enough to split
        raise AssertionError(f"merge kernel launches {merges} not in (0, {launches}]")
    main_t = timed["main"]
    log(json.dumps({"kernels": [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode/kernel.py:87",
        "launches": launches,
        "merge_launches": merges,
        "max_abs_err": main_t["max_abs_err"],
        "max_abs_err_sweep": worst,
        "ms": main_t["ms"],
        "kernel_ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shape": "B=8 H=16 KV=8 hd=128 page=16 bf16 sum(lens)=%d" % main_t["sum_lens"],
    }]}))
    s = engine.stats
    log(json.dumps({"serve": {
        "model": cfg.name, "dtype": cfg.activation_dtype, "layers": cfg.num_layers,
        "requests": len(m.finished), "output_tok_s": m.throughput,
        "total_tok_s": m.token_throughput, "ttft_s": m.ttft(), "tpot_s": m.tpot(),
        "makespan_s": m.makespan, "iterations": s.iterations,
        "offloaded_decodes": s.offloaded_decodes, "device_decodes": s.device_decodes,
        "swap_bytes": engine.pool.swap_bytes, "decode_calls": calls,
        "kernel_launches": launches, "merge_kernel_launches": merges,
        "modes": s.mode_counts,
        "host_attention_busy_s": s.host_busy_time, "plan_busy_s": s.plan_busy_time,
        "lane_busy_s": s.lane_busy_time, "card": card}}))
    del engine
    torch.cuda.empty_cache()

    # -- phase 4: parity on the card -----------------------------------------
    par = parity_phase(torch, cfg, "cuda", trace)
    log(json.dumps({"parity": par}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
