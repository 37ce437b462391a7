"""Serving launcher of the port.

Runs the port's NeoEngine on the card (``--device cpu`` for the CPU) through
one of two loops, as the JAX launcher does:

* :func:`run_trace` — closed loop: requests are submitted as their arrival
  time passes, one engine step per loop turn;
* :func:`run_online` — open loop (``--arrivals poisson`` or
  ``replay:<path.jsonl>``): requests are OFFERED (admission control may
  reject them), join the running batch mid-flight and stream out as they
  finish, while plan-ahead builds the next iteration's plan.

``--sustained`` runs :func:`run_sustained`, the A/B gate of closed-loop
lockstep against open loop with plan-ahead.  :func:`run_conversations` is
the closed-loop multi-turn driver of the reference's prefix-cache
benchmark (a conversation's next turn goes in when its last one finished).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --trace osc --n 8 --rate 4 --policy neo
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --arrivals poisson --n 24 --rate 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b

Flags are the JAX launcher's; the engine is pipelined unless
``--no-pipeline``.  The dense archs run through the paged engine;
``rwkv6-7b`` (ssm) and ``zamba2-7b`` (hybrid) through the contiguous engine,
for which the pool flags (``--device-pages``, ``--host-pages``) and the
pipeline flags do not apply and are ignored, as the JAX launcher ignores
them, and ``--max-batch-tokens`` is each slot's capacity.  ``--trace-out``
(or ``--require-reconcile``) switches engine tracing on: the serve writes a
Chrome trace-event JSON (Perfetto-loadable) and the counter time-series as
``<stem>.counters.jsonl`` beside it (or at ``--counters-out``), and adds the
``reconcile()`` audit of the spans against ``EngineStats`` to its JSON
summary; with ``--require-reconcile`` it exits 1 when the audit fails:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --trace-out trace.json --require-reconcile
  PYTHONPATH=src python -m repro_torch.obs.validate trace.json \
      --expect-host-lane --expect-copy --min-adopts 1

``--prefix-cache`` switches the two-tier radix prefix cache on; its summary
keys (``prefill_tokens_computed``, ``hit_rate``, ``prefix_*``,
``inplace_host_hits``, ...) are the reference's, and so are its gates:
``--require-hits`` exits 1 on a zero hit rate, ``--host-serving`` unless a
host-resident prefix was served in place with next to no PCIe bytes:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --trace multiturn --prefix-cache --require-hits --host-serving

``--spec-decode`` switches speculative decoding on (the n-gram drafter,
up to ``--spec-k`` drafts per row and step); ``--draft-model <arch>``
drafts with that model instead (random weights seeded ``--seed + 1``, on
the target's device and dtype; its vocabulary must be the target's);
``--require-accepts`` exits 1 when no drafted token was accepted:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
      --device cpu --trace osc --n 12 --rate 2 --policy fastdecode \
      --spec-decode --spec-k 4 --require-accepts
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --n 4 \
      --device-pages 256 --draft-model qwen3-0.6b --spec-decode

``--tp N`` serves with gather-TP over N shards (dense family, paged
engine; greedy tokens those of ``--tp 1``): on the card over ``cuda:0`` ..
``cuda:N-1`` (a ValueError when there are fewer cards), with ``--device
cpu`` over N CPU shards:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
      --device cpu --tp 2 --n 6 --device-pages 16 --host-pages 64
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.config import EngineConfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.engine import NeoEngine
from repro_torch.core.request import RequestState
from repro_torch.core.spec import DraftModelDrafter
from repro_torch.models.api import get_model
from repro_torch.obs.reconcile import reconcile
from repro_torch.serving.metrics import RequestRecord, ServeMetrics
from repro_torch.serving.traces import get_trace, save_trace

SLO_TTFT, SLO_TPOT = 10.0, 1.0  # the JAX launcher's defaults


def _mirror_stats(engine: NeoEngine, metrics: ServeMetrics) -> None:
    """Copy EngineStats and prefix-cache counters into a ServeMetrics."""
    s = engine.stats
    metrics.iterations = s.iterations
    metrics.mode_counts = dict(s.mode_counts)
    metrics.offloaded_decodes = s.offloaded_decodes
    metrics.device_decodes = s.device_decodes
    metrics.host_busy_time = s.host_busy_time
    metrics.device_busy_time = s.device_busy_time
    metrics.pipeline_overlap_time = s.pipeline_overlap_time
    metrics.bubble_fraction = s.bubble_fraction
    metrics.swap_hidden_bytes = s.swap_hidden_bytes
    metrics.swap_wait_time = s.swap_wait_time
    metrics.microbatched_steps = s.microbatched_steps
    metrics.serial_b1_steps = s.serial_b1_steps
    metrics.borrowed_lane_steps = s.borrowed_lane_steps
    metrics.lane_count_steps = dict(s.lane_counts)
    metrics.lane_busy = dict(s.lane_busy_time)
    metrics.prefill_tokens_computed = s.prefill_tokens
    metrics.planahead_hits = s.planahead_hits
    metrics.planahead_replans = s.planahead_replans
    metrics.planahead_skipped = s.planahead_skipped
    metrics.plan_busy_time = s.plan_busy_time
    metrics.planahead_hidden_time = s.planahead_hidden_time
    metrics.rejected_requests = s.rejected_requests
    metrics.spec_steps = s.spec_steps
    metrics.drafted_tokens = s.drafted_tokens
    metrics.accepted_tokens = s.accepted_tokens
    metrics.rejected_drafts = s.rejected_drafts
    metrics.spec_busy_time = s.spec_busy_time
    metrics.accept_len_hist = dict(s.accept_len_hist)
    if getattr(engine, "prefix_cache", None) is not None:
        ps = engine.prefix_cache.stats
        metrics.prefix_hit_rate = ps.hit_rate
        metrics.prefix_hits = ps.hits
        metrics.prefix_lookups = ps.lookups
        metrics.prefix_hit_tokens = ps.hit_tokens
        metrics.prefix_promoted_pages = ps.promoted_pages
        metrics.prefix_demoted_pages = ps.demoted_pages
        metrics.prefix_evicted_pages = ps.evicted_pages
        metrics.prefix_cow_copies = ps.cow_copies
        metrics.inplace_host_hits = ps.inplace_host_hits
        metrics.host_served_hit_tokens = ps.host_served_hit_tokens
        metrics.host_hit_pcie_bytes = ps.host_hit_pcie_bytes
    if engine.pool is not None:
        metrics.swap_bytes = engine.pool.swap_bytes


def run_trace(engine: NeoEngine, trace, *, vocab: int, seed: int = 0,
              extras_fn=None, max_iters: int = 100_000) -> ServeMetrics:
    """Feed a trace into a real engine, respecting arrival times (virtual
    clock advanced by wall-time of each iteration).  ``extras_fn(tr)``
    gives a trace request's model inputs beside its tokens (``submit``'s
    ``extras``)."""
    rng = np.random.default_rng(seed)
    pending = sorted(trace, key=lambda t: t.arrival_time)
    for t in pending:
        t.materialise(rng, vocab)
    metrics = ServeMetrics()
    records = {}
    i = 0
    iters = 0
    t0 = time.perf_counter()
    while iters < max_iters:
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].arrival_time <= now:
            tr = pending[i]
            extras = extras_fn(tr) if extras_fn else None
            rid = engine.submit(tr.prompt, tr.output_len, arrival_time=tr.arrival_time,
                                extras=extras)
            records[rid] = RequestRecord(rid, tr.arrival_time, tr.prompt_len, tr.output_len)
            metrics.records.append(records[rid])
            i += 1
        emitted = engine.step(now=now)
        iters += 1
        done_now = time.perf_counter() - t0
        for rid, req in engine.requests.items():
            rec = records.get(rid)
            if rec is None:
                continue
            if req.first_token_time is not None and rec.first_token_time is None:
                rec.first_token_time = done_now
            if req.finish_time is not None and rec.finish_time is None:
                rec.finish_time = done_now
                rec.status = ("cancelled"
                              if req.state == RequestState.ABORTED
                              else "finished")
        if not emitted and i >= len(pending) and engine.scheduler.num_queued == 0:
            break
        if not emitted and i < len(pending):
            time.sleep(max(0.0, pending[i].arrival_time - (time.perf_counter() - t0)))
    metrics.makespan = time.perf_counter() - t0
    _mirror_stats(engine, metrics)
    return metrics


def run_conversations(engine: NeoEngine, trace, *, max_iters: int = 100_000) -> ServeMetrics:
    """Closed-loop multi-turn driver, the reference benchmark's
    (``benchmarks/prefix_cache.py::drive``): the conversations of a
    materialised ``multiturn`` trace run side by side, and a conversation's
    next turn (turns in prompt-length order: each extends the last) is
    submitted only after its previous turn finished, the user having read
    the answer.  Each turn's record starts when it is submitted, so its TTFT
    is the wait the user sees."""
    by_conv = collections.defaultdict(list)
    for t in trace:
        by_conv[t.conv].append(t)
    convs = [sorted(c, key=lambda t: t.prompt_len) for _, c in sorted(by_conv.items())]
    metrics = ServeMetrics()
    records = {}
    cursors = [0] * len(convs)
    pending: Dict[int, int] = {}  # rid -> conversation
    iters = 0
    t0 = time.perf_counter()
    while iters < max_iters:
        now = time.perf_counter() - t0
        busy = set(pending.values())
        for ci, conv in enumerate(convs):
            if cursors[ci] < len(conv) and ci not in busy:
                tr = conv[cursors[ci]]
                cursors[ci] += 1
                rid = engine.submit(tr.prompt, tr.output_len, arrival_time=now)
                records[rid] = RequestRecord(rid, now, tr.prompt_len, tr.output_len)
                metrics.records.append(records[rid])
                pending[rid] = ci
        if not pending:
            break
        engine.step(now=now)
        iters += 1
        done_now = time.perf_counter() - t0
        for rid in list(pending):
            req, rec = engine.requests[rid], records[rid]
            if req.first_token_time is not None and rec.first_token_time is None:
                rec.first_token_time = done_now
            if req.finish_time is not None:
                rec.finish_time = done_now
                rec.status = "cancelled" if req.state == RequestState.ABORTED else "finished"
                del pending[rid]
    metrics.makespan = time.perf_counter() - t0
    _mirror_stats(engine, metrics)
    return metrics


def run_online(engine: NeoEngine, trace, *, vocab: int, seed: int = 0,
               extras_fn=None, max_iters: int = 100_000, on_token=None) -> ServeMetrics:
    """Open-loop continuous-batching loop.

    Requests are OFFERED as their arrival time passes; admission control
    (``EngineConfig.max_waiting``) may reject them, and a rejected request
    keeps a terminal record.  Admitted requests join the running batch
    mid-flight and depart the moment they finish.  ``on_token(rid, token)``
    is called once per newly emitted token, in emission order per request.
    ``extras_fn`` as in :func:`run_trace`.
    """
    rng = np.random.default_rng(seed)
    pending = sorted(trace, key=lambda t: t.arrival_time)
    for t in pending:
        t.materialise(rng, vocab)
    metrics = ServeMetrics()
    records = {}
    streamed = {}  # rid -> tokens already handed to on_token
    i = 0
    iters = 0
    t0 = time.perf_counter()
    while iters < max_iters:
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].arrival_time <= now:
            tr = pending[i]
            extras = extras_fn(tr) if extras_fn else None
            rid = engine.offer(tr.prompt, tr.output_len, arrival_time=tr.arrival_time,
                               extras=extras)
            i += 1
            if rid is None:
                metrics.record_rejection(tr.arrival_time, tr.prompt_len,
                                         tr.output_len, "max_waiting")
                continue
            records[rid] = RequestRecord(rid, tr.arrival_time, tr.prompt_len, tr.output_len)
            metrics.records.append(records[rid])
        emitted = engine.step(now=now)
        iters += 1
        done_now = time.perf_counter() - t0
        for rid, req in engine.requests.items():
            rec = records.get(rid)
            if rec is None:
                continue
            if req.first_token_time is not None and rec.first_token_time is None:
                rec.first_token_time = done_now
            if on_token is not None:
                seen = streamed.get(rid, 0)
                for tok in req.out_tokens[seen:]:
                    on_token(rid, tok)
                streamed[rid] = len(req.out_tokens)
            if req.finish_time is not None and rec.finish_time is None:
                rec.finish_time = done_now
                rec.status = ("cancelled"
                              if req.state == RequestState.ABORTED
                              else "finished")
        if not emitted and i >= len(pending) and engine.scheduler.num_queued == 0:
            break
        if not emitted and i < len(pending):
            time.sleep(max(0.0, pending[i].arrival_time - (time.perf_counter() - t0)))
    metrics.makespan = time.perf_counter() - t0
    _mirror_stats(engine, metrics)
    return metrics


def _clamp_trace(trace, max_batch_tokens: int, max_output: int = 32):
    """Clamp lengths to smoke scale, as the JAX launcher does."""
    for t in trace:
        t.prompt_len = min(t.prompt_len, max_batch_tokens // 4)
        if t.prompt is not None:
            t.prompt = t.prompt[: t.prompt_len]
        t.output_len = min(t.output_len, max_output)
    return trace


def run_sustained(*, arch: str = "qwen3-0.6b", smoke: bool = True,
                  policy: str = "neo", trace_name: str = "osc",
                  n: int = 24, rate: float = 8.0,
                  device_pages: int = 64, host_pages: int = 256,
                  max_batch_tokens: int = 2048,
                  slo_ttft: float = SLO_TTFT, slo_tpot: float = SLO_TPOT,
                  max_output: int = 16, seed: int = 0,
                  goodput_tol: float = 0.95, device=None, dtype=None, layers=None,
                  params=None, ewma_alpha=None, outputs=None) -> dict:
    """Sustained-load A/B gate: closed-loop lockstep (plan-ahead OFF) vs
    the open-loop runner with plan-ahead ON, on the same trace, seed and
    random weights.  Per-row compute does not depend on the plan, so the two
    runs must emit the same tokens per request.  Gates: ``planahead_hits >
    0``, identical outputs, open-loop p99 TTFT within the SLO, open-loop
    goodput >= ``goodput_tol`` x closed-loop goodput.

    ``dtype`` overrides the config's and ``layers`` cuts its depth;
    ``params`` are the weights (else seeded random ones); ``ewma_alpha``
    overrides the engine config's; ``outputs``, when
    given, receives each loop's tokens by request (``closed``, ``open``)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, activation_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    extra = {} if ewma_alpha is None else {"ewma_alpha": ewma_alpha}

    def build(planahead: bool) -> NeoEngine:
        ecfg = EngineConfig(
            device_pool_pages=device_pages, host_pool_pages=host_pages,
            max_batch_tokens=max_batch_tokens, policy=policy,
            planahead=planahead, seed=seed, **extra)
        return NeoEngine(cfg, ecfg, device=device, params=params)

    def mk_trace():
        return _clamp_trace(get_trace(trace_name, n, rate, seed), max_batch_tokens, max_output)

    def tokens_of(engine: NeoEngine):
        return {rid: list(r.out_tokens) for rid, r in engine.requests.items()}

    closed = build(planahead=False)
    m_closed = run_trace(closed, mk_trace(), vocab=cfg.vocab_size, seed=seed)
    out_closed = tokens_of(closed)
    closed.close()

    open_ = build(planahead=True)
    m_open = run_online(open_, mk_trace(), vocab=cfg.vocab_size, seed=seed)
    out_open = tokens_of(open_)
    open_.close()
    if outputs is not None:
        outputs.update(closed=out_closed, open=out_open)

    g_closed = m_closed.goodput(slo_ttft, slo_tpot)
    g_open = m_open.goodput(slo_ttft, slo_tpot)
    p99_ttft_open = m_open.ttft(99)
    gates = {
        "planahead_hits_gt0": m_open.planahead_hits > 0,
        "bitwise_identical": out_open == out_closed,
        "p99_ttft_within_slo": bool(p99_ttft_open <= slo_ttft),
        "goodput_no_regress": bool(g_open >= goodput_tol * g_closed),
    }
    return {
        "policy": policy,
        "trace": trace_name,
        "n": n,
        "rate_rps": rate,
        "slo_ttft_s": slo_ttft,
        "slo_tpot_s": slo_tpot,
        "closed": {
            "goodput_rps": round(g_closed, 3),
            "makespan_s": round(m_closed.makespan, 3),
            "ttft_p99_ms": round(m_closed.ttft(99) * 1e3, 2),
            "tpot_p99_ms": round(m_closed.tpot(99) * 1e3, 2),
            "plan_busy_s": round(m_closed.plan_busy_time, 4),
        },
        "open": {
            "goodput_rps": round(g_open, 3),
            "makespan_s": round(m_open.makespan, 3),
            "ttft_p99_ms": round(p99_ttft_open * 1e3, 2),
            "tpot_p99_ms": round(m_open.tpot(99) * 1e3, 2),
            "plan_busy_s": round(m_open.plan_busy_time, 4),
            "planahead_hits": m_open.planahead_hits,
            "planahead_replans": m_open.planahead_replans,
            "planahead_skipped": m_open.planahead_skipped,
            "planahead_hidden_s": round(m_open.planahead_hidden_time, 4),
            "rejected_requests": m_open.rejected_requests,
        },
        "gates": gates,
        "pass": all(gates.values()),
    }


def draft_model_drafter(target_cfg, draft_arch: str, *, smoke: bool, seed: int,
                        device) -> DraftModelDrafter:
    """The ``--draft-model`` drafter: ``draft_arch``'s model (its smoke
    config under ``smoke``) with random weights from a generator seeded
    ``seed + 1``, as the reference seeds it, on ``device`` in the target's
    dtype.  Raises ValueError, with the reference's message, when the
    vocabularies differ (drafted ids are proposed verbatim)."""
    dcfg = get_smoke_config(draft_arch) if smoke else get_config(draft_arch)
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(f"draft vocab {dcfg.vocab_size} != target vocab "
                         f"{target_cfg.vocab_size} (token ids are proposed verbatim)")
    dcfg = dcfg.replace(param_dtype=target_cfg.param_dtype,
                        activation_dtype=target_cfg.activation_dtype)
    model = get_model(dcfg, device=device)
    model.init(torch.Generator(device=model.device).manual_seed(seed + 1))
    return DraftModelDrafter(model, vocab_size=target_cfg.vocab_size)


def frames_extras(cfg, seed: int):
    """``extras_fn`` for the CLI: an encoder-decoder's requests get seeded
    frames [encoder_memory_len, d], the stubbed speech frontend's output
    (the reference's CLI passes none, and its encoder cannot run without
    them); every other family serves text only, as the reference's CLI
    does (a vlm's requests carry no patches)."""
    if cfg.encdec is None:
        return None
    rng = np.random.default_rng(seed + 2)
    shape = (cfg.encdec.encoder_memory_len, cfg.d_model)
    return lambda tr: {"frames": rng.standard_normal(shape, dtype=np.float32)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (the card by default)")
    ap.add_argument("--policy", default="neo",
                    choices=["neo", "gpu_only", "fastdecode", "simple"])
    ap.add_argument("--trace", default="osc")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--device-pages", type=int, default=64)
    ap.add_argument("--host-pages", type=int, default=256)
    ap.add_argument("--max-batch-tokens", type=int, default=2048)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial reference execution (no async swaps/overlap)")
    ap.add_argument("--no-microbatch", action="store_true",
                    help="disable multi-lane batch-1 splitting")
    ap.add_argument("--max-host-lanes", type=int, default=EngineConfig.max_host_lanes,
                    help="upper bound K on concurrent host lanes per plan")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="two-tier radix prefix cache (copy-on-write KV page sharing)")
    ap.add_argument("--require-hits", action="store_true",
                    help="exit 1 if the prefix-cache hit rate is 0")
    ap.add_argument("--host-serving", action="store_true",
                    help="exit 1 unless a host-resident prefix was served in place "
                         "(inplace_host_hits > 0) with host-hit PCIe bytes within a "
                         "small epsilon")
    ap.add_argument("--arrivals", default="closed",
                    help="closed = lockstep runner (run_trace); poisson = open loop "
                         "(run_online) with the --trace generator's arrivals; "
                         "replay:<path.jsonl> = open loop with replayed arrivals")
    ap.add_argument("--no-planahead", action="store_true",
                    help="plan on the critical path every step")
    ap.add_argument("--max-waiting", type=int, default=0)
    ap.add_argument("--slo-ttft", type=float, default=SLO_TTFT)
    ap.add_argument("--slo-tpot", type=float, default=SLO_TPOT)
    ap.add_argument("--sustained", action="store_true",
                    help="sustained-load A/B gate (closed lockstep vs open loop + "
                         "plan-ahead); exit 1 when a gate fails")
    ap.add_argument("--save-trace", default="",
                    help="write the (clamped) trace as JSONL for replay")
    ap.add_argument("--trace-out", default="",
                    help="switch engine tracing on and write the Chrome trace-event "
                         "JSON here; the counters go to <stem>.counters.jsonl unless "
                         "--counters-out is given")
    ap.add_argument("--counters-out", default="",
                    help="JSONL sink for the tracer's counter time-series "
                         "(queue depths, free pages); requires --trace-out")
    ap.add_argument("--require-reconcile", action="store_true",
                    help="exit 1 unless reconcile(), the audit of the spans against "
                         "EngineStats, passes (switches tracing on)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shard count: column-sharded QKV/gate/up with a "
                         "gather before the replicated O/down projections, so greedy "
                         "outputs stay those of --tp 1 (needs N cards, or --device cpu)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: n-gram drafter + one batched verify pass "
                         "per step; greedy outputs stay those of non-speculative decode")
    ap.add_argument("--spec-k", type=int, default=EngineConfig.spec_k,
                    help="max drafted tokens per row per step; the perf model prices K "
                         "in [1, spec_k] each plan")
    ap.add_argument("--draft-model", default="",
                    help="arch of a small draft model (e.g. qwen3-0.6b) to draft with "
                         "instead of the n-gram drafter; implies --spec-decode")
    ap.add_argument("--require-accepts", action="store_true",
                    help="exit 1 if speculative decoding accepted 0 drafted tokens")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.sustained:
        result = run_sustained(
            arch=args.arch, smoke=args.smoke, policy=args.policy,
            trace_name=args.trace, n=args.n, rate=args.rate,
            device_pages=args.device_pages, host_pages=args.host_pages,
            max_batch_tokens=args.max_batch_tokens,
            slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
            seed=args.seed, device=args.device)
        print(json.dumps(result, indent=1))
        if not result["pass"]:
            failed = [k for k, ok in result["gates"].items() if not ok]
            print(f"[serve] FAIL: sustained-load gates failed: {failed}")
            return 1
        print("[serve] sustained-load OK: open loop + plan-ahead holds goodput at "
              "the SLO with identical outputs")
        return 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tracing = bool(args.trace_out) or args.require_reconcile
    ecfg = EngineConfig(
        device_pool_pages=args.device_pages,
        host_pool_pages=args.host_pages,
        max_batch_tokens=args.max_batch_tokens,
        policy=args.policy,
        pipeline=not args.no_pipeline,
        microbatch=not args.no_microbatch,
        max_host_lanes=args.max_host_lanes,
        planahead=not args.no_planahead,
        max_waiting=args.max_waiting,
        prefix_cache=args.prefix_cache,
        tracing=tracing,
        spec_decode=args.spec_decode or bool(args.draft_model),
        spec_k=args.spec_k,
        tp=args.tp,
        seed=args.seed,
    )
    open_loop = args.arrivals != "closed"
    print(f"[serve] arch={cfg.name} policy={args.policy} device={args.device} "
          f"pipeline={not args.no_pipeline} microbatch={not args.no_microbatch} "
          f"prefix_cache={args.prefix_cache} planahead={not args.no_planahead} "
          f"arrivals={args.arrivals} tp={args.tp} spec={ecfg.spec_decode} "
          f"pools=({args.device_pages},{args.host_pages})")
    drafter = None
    if args.draft_model:
        try:
            drafter = draft_model_drafter(cfg, args.draft_model, smoke=args.smoke,
                                          seed=args.seed, device=args.device)
        except ValueError as e:
            print(f"[serve] FAIL: {e}")
            return 1
        print(f"[serve] draft model: {drafter.model.cfg.name} (window={drafter.window})")
    engine = NeoEngine(cfg, ecfg, device=args.device)
    if drafter is not None:
        engine.drafter = drafter
    if args.arrivals.startswith("replay:"):
        trace = get_trace(args.arrivals, args.n, args.rate, args.seed)
    else:
        trace = get_trace(args.trace, args.n, args.rate, args.seed)
    _clamp_trace(trace, args.max_batch_tokens)
    if args.save_trace:
        save_trace(trace, args.save_trace)
        print(f"[serve] wrote {len(trace)} requests to {args.save_trace}")
    runner = run_online if open_loop else run_trace
    m = runner(engine, trace, vocab=cfg.vocab_size, seed=args.seed,
               extras_fn=frames_extras(cfg, args.seed))
    engine.close()
    summary = m.summary()
    report = None
    if engine.tracer is not None:
        if args.trace_out:
            doc = engine.tracer.export_chrome(args.trace_out)
            print(f"[serve] wrote {len(doc['traceEvents'])} trace events to "
                  f"{args.trace_out} (recorded={engine.tracer.total} "
                  f"dropped={engine.tracer.dropped})")
            counters_out = args.counters_out
            if not counters_out:
                stem = args.trace_out
                if stem.endswith(".json"):
                    stem = stem[: -len(".json")]
                counters_out = stem + ".counters.jsonl"
            n_c = engine.tracer.export_counters_jsonl(counters_out)
            print(f"[serve] wrote {n_c} counter samples to {counters_out}")
        report = reconcile(engine.tracer, engine.stats)
        summary["reconcile"] = report.summary()
    print(json.dumps(summary, indent=1))
    print("scheduler modes:", m.mode_counts)
    if args.require_reconcile and not report.ok:
        print(f"[serve] FAIL: the span timeline disagrees with EngineStats: {report.failed()}")
        return 1
    if args.require_hits and m.prefix_hit_rate <= 0.0:
        print("[serve] FAIL: prefix-cache hit rate is 0 on a shared-prefix trace")
        return 1
    if ecfg.spec_decode:
        s = engine.stats
        print(f"[serve] spec: steps={s.spec_steps} drafted={s.drafted_tokens} "
              f"accepted={s.accepted_tokens} rejected={s.rejected_drafts} "
              f"hist={dict(sorted(s.accept_len_hist.items()))}")
        if args.require_accepts and s.accepted_tokens == 0:
            print("[serve] FAIL: speculative decoding accepted 0 drafted tokens under "
                  "--require-accepts")
            return 1
    if args.host_serving:
        return _host_serving_gate(engine, m)
    return 0


def _host_serving_gate(engine, m: ServeMetrics) -> int:
    """The reference's zero-copy host-serving gate: at least one in-place
    host hit, and host-hit PCIe bytes within two pages plus 10% of the
    host-served volume (a host preference the balancer bounced falls back
    to the device and rightly promotes its prefix; wholesale promotion of
    host-resident prefixes fails)."""
    page_bytes = page_tokens = 0
    if engine.prefix_cache is not None:
        page_bytes = engine.prefix_cache.page_nbytes()
        page_tokens = engine.prefix_cache.page
    served_pages = m.host_served_hit_tokens / max(page_tokens, 1)
    eps = int(page_bytes * (2 + 0.1 * served_pages))
    if m.inplace_host_hits <= 0:
        print("[serve] FAIL: no in-place host-served prefix hits (inplace_host_hits == 0) "
              "under --host-serving")
        return 1
    if m.host_hit_pcie_bytes > eps:
        print(f"[serve] FAIL: host-resident prefix hits crossed PCIe "
              f"({m.host_hit_pcie_bytes} B > eps {eps} B)")
        return 1
    print(f"[serve] host-serving OK: inplace_host_hits={m.inplace_host_hits} "
          f"host_served_hit_tokens={m.host_served_hit_tokens} "
          f"host_hit_pcie_bytes={m.host_hit_pcie_bytes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
