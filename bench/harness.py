"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the metrics.

The system under test is ``repro_torch``'s ``NeoEngine``, driven through
``submit`` and ``step`` alone, built from the configuration file's ``port``
fields with ``policy="neo"``, the device pool sized by the benchmark's rule,
the host pool as the traffic mix says, and every other knob at the
program's default.  Set-up: the kernels are built (or found in the
checkout's ``build/kernels``), the weights drawn on the device, the engine
built, the traffic's first wave run until every one of its requests has
its first token, and its arrivals fed for the mix's ``warmup_s``.  Then
the window runs for ``seconds``.  With ``trace`` the
window's last part runs under ``torch.profiler`` and the engine's span
tracer, and the run reports the per-layer metrics.
"""

from __future__ import annotations

import gc
import heapq
import importlib
import importlib.util
import json
import os
import platform
import re
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from bench import compare, traffic as traffic_lib, weights as weights_lib, yardstick
from bench.reference.moe import padded_len
from bench.window import Rec, Step, Window, tpot_samples, ttft_samples

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SLICE_S = 10.0  # the traced part of the window: its last seconds, at most this long


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict[str, Any]:
    return read_json(ROOT / "BENCHMARK.json")


def cell_of(spec: Mapping, name: str) -> Dict[str, Any]:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Dict[str, Any]:
    return read_json(BENCH / "configs" / f"{name}.json")


def mix_file(name: str) -> Dict[str, Any]:
    return read_json(BENCH / "traffic" / f"{name}.json")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (its ``read(run)``)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str):
    return importlib.import_module(f"bench.reference.{family}")


def metrics_for(spec: Mapping, cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------


def device_pages(cfg: Mapping) -> int:
    return yardstick.device_pages(cfg, cfg["assumed"])


def build_engine(cfg: Mapping, mix: Mapping, params: Mapping, device):
    from repro_torch.config import ArchConfig, EngineConfig, MoEConfig
    from repro_torch.core.engine import NeoEngine

    port = dict(cfg["port"])
    moe = port.pop("moe", None)
    arch = ArchConfig(**port, moe=MoEConfig(**moe) if moe else None)
    pages = device_pages(cfg)
    pools = {"device_pool_pages": pages}
    if mix.get("host_pool_share"):
        pools["host_pool_pages"] = int(round(mix["host_pool_share"] * pages))
    # the deployment's knobs: the configuration's, then the traffic's
    # (a mix that needs, say, the prefix cache turns it on)
    knobs = {**cfg["assumed"]["engine"], **mix.get("engine", {})}
    ecfg = EngineConfig(**pools, **knobs, policy="neo")
    return NeoEngine(arch, ecfg, params=params, device=device)


def stats_snapshot(engine) -> Dict[str, Any]:
    """Every number and table of the engine's counters (``EngineStats``,
    and ``transfer.`` / ``prefix.`` for ``TransferStats`` and
    ``PrefixCacheStats``), copied, so a reader can take any delta."""
    snap: Dict[str, Any] = {}
    parts = [("", engine.stats), ("transfer.", getattr(engine.transfer, "stats", None)),
             ("prefix.", getattr(engine.prefix_cache, "stats", None))]
    for prefix, obj in parts:
        for k, v in (vars(obj) if obj is not None else {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                snap[prefix + k] = v
            elif isinstance(v, dict):
                snap[prefix + k] = dict(v)
    return snap


class EngineLoop:
    """Submits requests, steps the engine and records what each step did,
    from the engine's emitted tokens and its requests' state."""

    def __init__(self, engine, clock: Callable[[], float] = time.perf_counter):
        from repro_torch.core.request import RequestState

        self.engine = engine
        self.clock = clock
        self.state = RequestState
        self.recs: Dict[int, Rec] = {}
        self.active: Dict[int, Rec] = {}
        self.win: Optional[Window] = None
        self.max_padded = 0  # the largest prefill batch, padded, in tokens

    def submit(self, ask: traffic_lib.Ask, due: float) -> Rec:
        rid = self.engine.submit(ask.prompt, ask.max_new_tokens)
        now = self.clock()
        rec = Rec(rid, ask.prompt, ask.max_new_tokens, due, now)
        self.recs[rid] = self.active[rid] = rec
        return rec

    def step(self) -> List[Rec]:
        """One engine step; returns the requests it finished."""
        eng, st = self.engine, self.state
        prefilled0 = eng.stats.prefill_tokens
        t0 = self.clock()
        emitted = eng.step()
        t1 = self.clock()
        in_win = self.win is not None
        dev_ctx: List[int] = []
        host_ctx: List[int] = []
        new: List[Rec] = []
        done: List[Rec] = []
        for rid, tok in emitted:
            rec, req = self.active[rid], eng.requests[rid]
            if not rec.tokens:
                rec.first = t1
                new.append(rec)
            else:
                ctx = len(req.prompt) + len(req.out_tokens) - 1
                if req.location == "cpu":
                    host_ctx.append(ctx)
                    rec.host_tokens += 1
                else:
                    dev_ctx.append(ctx)
            rec.tokens.append(int(tok))
            if in_win:
                self.win.tokens += 1
                rec.win_n += 1
                rec.win_first = t1 if rec.win_first is None else rec.win_first
                rec.win_last = t1
            if req.state is st.FINISHED:
                rec.finished = t1
                done.append(self.active.pop(rid))
        lens = [len(r.prompt) for r in new]
        replayed = eng.stats.prefill_tokens - prefilled0 - sum(lens)
        if lens:
            self.max_padded = max(self.max_padded, len(lens) * padded_len(max(lens)))
        if replayed > 0:
            lens.append(replayed)  # a replay's length is unknown to the batch
        elif new:
            for r in new:
                r.batch_len = max(lens)
        for rec in self.active.values():
            if rec.tokens and eng.requests[rec.rid].state is st.WAITING:
                rec.preempted = True
        if in_win:
            self.win.steps.append(Step(t0, t1, dev_ctx, host_ctx, lens))
        return done


# ---------------------------------------------------------------------------
# the device trace of the window's last part
# ---------------------------------------------------------------------------


@dataclass
class TraceSlice:
    t0: float = 0.0  # host clock
    t1: float = 0.0
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # host clock
    spans: List[Tuple[str, str, float, float]] = field(default_factory=list)
    aligned: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, names: Tuple[str, ...]) -> float:
        return sum(b - a for n, a, b in self.kernels if any(k in n for k in names))


class Profiler:
    """Starts ``torch.profiler`` (device activity only) and the engine's
    span tracer once the window has ``start_s`` seconds behind it; stops
    both when the window has closed."""

    def __init__(self, engine, start_s: float):
        self.engine = engine
        self.start_s = start_s
        self.prof = None
        self.tracer = None
        self.slice = TraceSlice()
        self._offset_ns = 0

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def maybe_start(self, elapsed: float) -> None:
        if self.prof is not None or elapsed < self.start_s:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.obs.tracer import SpanTracer

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.tracer = SpanTracer(1 << 20)
        self.engine.attach_tracer(self.tracer)
        # the profiler stamps events on the wall clock; the engine and the
        # benchmark on perf_counter
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.slice.t0 = time.perf_counter()

    def stop(self) -> Optional[TraceSlice]:
        if self.prof is None:
            return None
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        sl = self.slice
        sl.t1 = time.perf_counter()
        self.engine.attach_tracer(None)
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = (e.start_ns() - self._offset_ns) / 1e9
            sl.kernels.append((e.name(), a, a + e.duration_ns() / 1e9))
        if sl.kernels:
            lo = min(k[1] for k in sl.kernels)
            hi = max(k[2] for k in sl.kernels)
            sl.aligned = sl.t0 - 0.01 <= lo and hi <= sl.t1 + 0.01
        sl.spans = [(ev.track, ev.name, ev.t0, ev.t1) for ev in self.tracer.events()
                    if ev.ph == "X"]
        return sl


def label_gaps(sl: TraceSlice, top: int = 10) -> List[List[Any]]:
    """Idle seconds between device operations, summed by the innermost
    engine span open at each gap's midpoint (layer numbers folded)."""
    gaps = []
    prev = sl.t0
    for a, b in sl.busy_intervals() + [(sl.t1, sl.t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans = sorted(sl.spans, key=lambda s: s[2]) if sl.aligned else []
    by_label: Dict[str, float] = {}
    heap: List[Tuple[float, int, str]] = []
    j = 0
    for a, b in sorted(gaps):
        m = (a + b) / 2
        while j < len(spans) and spans[j][2] <= m:
            track, name, s0, s1 = spans[j]
            heapq.heappush(heap, (s1, j, re.sub(r"\d+", "*", f"{track}/{name}")))
            j += 1
        while heap and heap[0][0] < m:
            heapq.heappop(heap)
        open_ = [(spans[k][3] - spans[k][2], lab) for _, k, lab in heap]
        label = min(open_)[1] if open_ else ("between engine spans" if sl.aligned
                                             else "unlabelled")
        by_label[label] = by_label.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(sl: TraceSlice, top: int = 10) -> List[List[Any]]:
    by_name: Dict[str, float] = {}
    for n, a, b in sl.kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """What the metric readers read."""

    cell: Mapping
    cfg: Mapping
    mix: Mapping
    setup_s: float
    win: Window
    recs: Dict[int, Rec]
    stats0: Dict[str, Any]
    stats1: Dict[str, Any]
    trace: Optional[TraceSlice] = None

    def delta(self, name: str) -> float:
        return self.stats1[name] - self.stats0[name]

    def lane_delta(self, lane: str) -> float:
        return (self.stats1["lane_busy_time"].get(lane, 0.0)
                - self.stats0["lane_busy_time"].get(lane, 0.0))

    def traced_steps(self) -> List[Step]:
        if self.trace is None:
            return []
        return [s for s in self.win.steps if s.t0 >= self.trace.t0]


def ensure_kernels(device) -> None:
    """Build (or find in ``build/kernels``) the paged decode and flash
    prefill libraries before anything is timed."""
    if getattr(device, "type", str(device)) != "cuda":
        return
    from repro_torch.kernels import _build

    _build.build_all([s for s in _build.SOURCES if s.stem in ("paged_decode", "flash_prefill")])


def run_cell(cell: Mapping, cfg: Mapping, mix: Mapping, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             after_window: Optional[Callable[[Any], None]] = None) -> Tuple[Run, Dict[str, Any]]:
    """Set-up, fill and window on ``device``, then the engine freed.
    Returns the run record and the run's facts: peak device memory, the
    requests due in the window and those the engine aborted.
    ``after_window`` sees the engine once the window has closed."""
    import torch

    ensure_kernels(device)
    ref = reference(cfg["family"])
    engine = build_engine(cfg, mix, weights_lib.Drawn(ref.weight_groups(cfg), seed, device),
                          device)
    cuda = torch.device(device).type == "cuda"
    drv = EngineLoop(engine)
    tr = traffic_lib.Traffic(mix, cfg, seed)
    lateness: List[float] = []
    # the steady state's requests in flight, each until its first token
    first = [drv.submit(a, drv.clock()).rid for a in tr.first_wave()]
    while any(drv.recs[r].first is None for r in first):
        drv.step()
    arrivals = tr.arrivals()
    origin = drv.clock()
    pending = [next(arrivals)]

    def feed() -> None:
        now = drv.clock()
        while origin + pending[0].due <= now:
            due = origin + pending[0].due
            rec = drv.submit(pending[0], due)
            if drv.win is not None:
                lateness.append(rec.submitted - due)
            pending[0] = next(arrivals)
        if not drv.active:
            time.sleep(max(0.0, origin + pending[0].due - drv.clock()))

    while drv.clock() < origin + mix["warmup_s"]:
        feed()
        drv.step()
    if cuda:
        torch.cuda.synchronize()
    prof = Profiler(engine, max(0.0, seconds - TRACE_SLICE_S)) if trace else None
    if prof is not None:
        prof.warm()
    stats0 = stats_snapshot(engine)
    win = Window(t0=drv.clock())
    drv.win = win
    setup_s = win.t0 - t_start
    while drv.clock() - win.t0 < seconds:
        if prof is not None:
            prof.maybe_start(drv.clock() - win.t0)
        feed()
        drv.step()
    win.t1 = drv.clock()
    drv.win = None
    win.lateness = lateness
    sl = prof.stop() if prof is not None else None
    stats1 = stats_snapshot(engine)
    run = Run(cell, cfg, mix, setup_s, win, drv.recs, stats0, stats1, sl)
    extra: Dict[str, Any] = {
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
        "attempted": sum(1 for r in drv.recs.values() if win.t0 <= r.due < win.t1),
        "failed": sum(1 for r in drv.recs.values()
                      if engine.requests[r.rid].state.name == "ABORTED"),
        "first_wave": len(first),
        "requests": len(drv.recs),
        "max_padded_prefill": drv.max_padded,
    }
    if after_window is not None:
        after_window(engine)
    engine.close()
    del engine, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, extra


def check(run: Run, seed: int, device, control: bool = False) -> Dict[str, Any]:
    """The reference over the chosen sample: the numbers compared, and with
    ``control`` the float8 control's over the same sequences."""
    ref = reference(run.cfg["family"])
    sample = compare.choose_sample(run.recs, seed, getattr(ref, "NEEDS_BATCH_LEN", False))
    if not sample:
        return {"requests_compared": 0}
    seqs = compare.sequences(sample)
    t0 = time.perf_counter()
    ref_logits = compare.reference_logits(ref, run.cfg, seed, seqs, device)
    out = compare.program_gap(ref_logits, seqs)
    out.update(requests_compared=len(sample),
               host_tokens_compared=sum(r.host_tokens for r in sample),
               reference_s=time.perf_counter() - t0)
    if control:
        ctrl = compare.reference_logits(ref, run.cfg, seed, seqs, device, quant="fp8")
        out["control"] = compare.control_gap(ref_logits, ctrl)
    return out


def host_record() -> Dict[str, Any]:
    """The card's name, power limit and SM clock, and the host beside it."""
    import torch

    rec: Dict[str, Any] = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        name, power, sm, sm_max = [x.strip() for x in q.stdout.splitlines()[0].split(",")]
        rec.update(gpu=name, power_limit=power, sm_clock=sm, sm_clock_max=sm_max)
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as err:
        rec["nvidia_smi"] = f"unread: {err}"
    try:
        with open("/proc/cpuinfo") as f:
            info = dict(ln.split(":", 1) for ln in f if ":" in ln)
        info = {k.strip(): v.strip() for k, v in info.items()}
        named = [info[k] for k in ("model name", "Model", "cpu model", "Hardware")
                 if info.get(k, "unknown") != "unknown"]
        rec["cpu"] = named[0] if named else " ".join(
            f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz")
            if k in info) or platform.machine()
        with open("/proc/meminfo") as f:
            kb = next(int(ln.split()[1]) for ln in f if ln.startswith("MemAvailable"))
        rec["mem_available_bytes"] = kb * 1024
    except (OSError, StopIteration, ValueError) as err:
        rec["proc"] = f"unread: {err}"
    rec["cores"] = len(os.sched_getaffinity(0))
    return rec


def step_time_by_rows(steps: List[Step], slice_rows: int = 64) -> List[Tuple[int, int, Tuple[int, float]]]:
    """The window's steps by how many slices of ``slice_rows`` decode rows
    they ran (the executor's ``ROW_SLICE``; each further slice reads every
    weight again): per bin, its row range, step count and mean step time."""
    bins: Dict[int, List[float]] = {}
    for st in steps:
        rows = len(st.dev_ctx) + len(st.host_ctx)
        bins.setdefault(-(-rows // slice_rows), []).append((st.t1 - st.t0) * 1e3)
    return [(max(0, (k - 1) * slice_rows + 1) if k else 0, k * slice_rows,
             (len(v), sum(v) / len(v))) for k, v in sorted(bins.items())]


def read_metrics(run: Run, metrics: List[Mapping]) -> Dict[str, Dict[str, Any]]:
    """Each metric from its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: Mapping, cfg: Mapping, mix: Mapping, metrics: List[Mapping], seed: int,
            seconds: float, trace: bool, device, t_start: float,
            log: Callable[[str], None] = lambda s: None) -> Dict[str, Any]:
    """One whole run: the result line's object, ``checks`` last."""
    import torch

    cuda = torch.device(device).type == "cuda"
    host: Dict[str, Any] = {}

    def beside_window(engine) -> None:
        if cuda:
            host.update(host_record())  # the SM clock as the window ends

    run, extra = run_cell(cell, cfg, mix, seed, seconds, trace, device, t_start, beside_window)
    win = run.win
    log(f"window {win.seconds:.3f} s, {len(win.steps)} steps, {win.tokens} tokens, "
        f"{extra['requests']} requests, {extra['first_wave']} in the first wave, setup {run.setup_s:.3f} s, "
        f"peak {extra['memory_peak_bytes']} B, largest padded prefill "
        f"{extra['max_padded_prefill']} tokens")
    ttft, tpot = ttft_samples(run.recs, win), tpot_samples(run.recs)
    log(f"samples: ttft {len(ttft)} requests due in the window, tpot {len(tpot)} requests "
        f"with >= 2 tokens in it")
    for lo, hi, ms in step_time_by_rows(win.steps):
        log(f"steps with {lo}-{hi} decode rows: {ms[0]} steps, mean {ms[1]:.3f} ms")
    if win.lateness:
        log(f"generator lateness: max {max(win.lateness):.6f} s, "
            f"mean {sum(win.lateness) / len(win.lateness):.6f} s over {len(win.lateness)}")
    checks = check(run, seed, device)
    log("compared: " + json.dumps({k: v for k, v in checks.items()}))
    values = read_metrics(run, metrics)
    compared = {name: {"value": checks.get(name), "limit": limit}
                for name, limit in cfg["limits"].items()}
    correct = (checks.get("requests_compared", 0) > 0 and extra["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": extra["memory_peak_bytes"],
        "host": host,
    }
    result: Dict[str, Any] = {"correct": correct, "attempted": extra["attempted"],
                              "failed": extra["failed"], "metrics": values, "device": dev}
    if run.trace is not None:
        sl = run.trace
        dev.update(busy_s=sl.busy_s, window_s=sl.seconds, trace_clock_aligned=sl.aligned,
                   trace_steps=len(run.traced_steps()))
        result["breakdown"] = {"device_ops": top_ops(sl), "idle_gaps": label_gaps(sl)}
    result["checks"] = compared
    return result
