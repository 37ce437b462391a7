"""Stage-time performance model (§3.2).

The paper profiles T_l (linear), T_ga (GPU attention) and T_ca (CPU attention)
offline for typical lengths and linearly interpolates; NEO additionally
refreshes the model online.  We implement that as an analytic roofline-style
base model (FLOPs / bandwidth terms from the hardware profile) multiplied by
per-stage calibration scale factors that are EWMA-updated from measured stage
times — the same mechanism doubles as straggler mitigation: a slow host pushes
its scale factor up and the scheduler offloads less.

All times are PER TRANSFORMER LAYER, matching the paper's
``T_tr = L × (max{T_l0, T_ca1} + max{T_l1 + T_ga0, T_ca0})``.

Speculative decoding adds a ``"verify"`` scale (:meth:`PerfModel.t_verify`
— the per-layer cost of the batched pseudo-row verification pass at
depth K) and an EWMA-tracked accept rate (``spec_accept``,
:meth:`observe_accept`); :meth:`spec_expected_emitted` turns the accept
rate into the expected emitted-token count the scheduler maximizes when
pricing K (``docs/spec_decode.md``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.config import ArchConfig
from repro_torch.roofline.hw import HardwareProfile, get_profile

# Fixed per-stage dispatch overheads (seconds): kernel launch / host dispatch.
# 75us/stage calibrates to a SwiftLLM-class Pythonic engine (the paper's §4
# discusses its launch overheads at length); a fused-XLA TPU engine would sit
# nearer 10-25us — the overhead is a perf-model knob, swept in tests.
GPU_STAGE_OVERHEAD = 75e-6
CPU_STAGE_OVERHEAD = 10e-6


@dataclass
class PerfModel:
    cfg: ArchConfig
    hw: HardwareProfile
    ewma_alpha: float = 0.2
    # tensor-parallel shard count: device-side resources in ``hw`` are
    # already ×tp (for_arch), host-side gathers divide by it, and the
    # collective term is non-zero only when tp > 1
    tp: int = 1
    # online calibration factors (measured / predicted), one per stage kind
    scale: Dict[str, float] = field(
        default_factory=lambda: {"linear": 1.0, "gpu_attn": 1.0, "cpu_attn": 1.0,
                                 "swap": 1.0, "host_prefix": 1.0,
                                 "collective": 1.0, "verify": 1.0}
    )
    # EWMA of the speculative-decoding per-draft accept rate (fraction of
    # drafted tokens the verify chain accepts).  Drives the scheduler's
    # choice of chain depth K: expected emissions per row for a depth-k
    # chain are the geometric sum (1 - a^(k+1)) / (1 - a).  Starts at 0.5
    # so the first speculative steps draft shallow chains until measured.
    spec_accept: float = 0.5

    @classmethod
    def for_arch(cls, cfg: ArchConfig, hw_name: str = "tpu_v5e",
                 ewma_alpha: float = 0.2, tp: int = 1):
        hw = get_profile(hw_name)
        if tp > 1:
            # TP scales device compute/bandwidth and PCIe lanes; the host stays
            # a single NUMA node (§5.1: "We confine our system to running on a
            # single NUMA node when running 2-GPU experiments").  pcie_bw × tp
            # is what divides t_swap by the shard count — each shard's stream
            # moves 1/tp of every page's kv heads over its own link.
            import dataclasses

            hw = dataclasses.replace(
                hw,
                device_flops=hw.device_flops * tp,
                device_hbm_bw=hw.device_hbm_bw * tp,
                device_hbm_bytes=hw.device_hbm_bytes * tp,
                pcie_bw=hw.pcie_bw * tp,
            )
        return cls(cfg=cfg, hw=hw, ewma_alpha=ewma_alpha, tp=max(1, tp))

    # -- derived per-layer constants (cached: param counting is eval_shape) ----
    @functools.cached_property
    def layer_params(self) -> float:
        """Active (per-token) parameters per layer, excluding embeddings."""
        cfg = self.cfg
        n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
        return max(n, 1) / max(cfg.num_layers, 1)

    @functools.cached_property
    def kv_bytes_per_token_layer(self) -> float:
        cfg = self.cfg
        return 2 * cfg.num_kv_heads * cfg.head_dim * 2  # K+V, bf16

    # -- stage estimators (seconds per layer) -----------------------------------
    def t_linear(self, n_tokens: int) -> float:
        """Pre+post projections + FFN for `n_tokens` rows, one layer."""
        if n_tokens <= 0:
            return 0.0
        p = self.layer_params
        flops = 2.0 * p * n_tokens
        t_compute = flops / (self.hw.device_flops * self.hw.linear_eff)
        t_mem = (p * 2) / self.hw.device_hbm_bw  # weights are read once per layer
        return self.scale["linear"] * (max(t_compute, t_mem) + GPU_STAGE_OVERHEAD)

    def t_prefill_attn(self, sq_token_sum: float) -> float:
        """Device prefill self-attention per layer.

        ``sq_token_sum`` = Σ S_i² over the prefill requests in the batch;
        causal flash attention ≈ 2·S²·H·hd FLOPs per layer (QKᵀ + PV, halved
        by causality), compute-bound.
        """
        if sq_token_sum <= 0:
            return 0.0
        flops = 2.0 * sq_token_sum * self.cfg.num_heads * self.cfg.head_dim
        return self.scale["linear"] * flops / (self.hw.device_flops * self.hw.linear_eff)

    def t_gpu_attn(self, kv_tokens: int) -> float:
        """Decode attention on device over `kv_tokens` total cached tokens."""
        if kv_tokens <= 0:
            return 0.0
        t = (kv_tokens * self.kv_bytes_per_token_layer) / (
            self.hw.device_hbm_bw * self.hw.attn_bw_eff
        )
        return self.scale["gpu_attn"] * (t + GPU_STAGE_OVERHEAD)

    def t_cpu_attn(self, kv_tokens: int) -> float:
        """Decode attention on the host over `kv_tokens` total cached tokens.

        Memory-bandwidth bound (§2.2): the host reads K+V once per step.
        The host KV cache is 16-bit (the paper's PACPU kernel streams fp16;
        this container's numpy pool is fp32 purely because numpy lacks bf16 —
        sizing and timing model the deployment layout).
        """
        if kv_tokens <= 0:
            return 0.0
        bytes_ = kv_tokens * 2 * self.cfg.num_kv_heads * self.cfg.head_dim * 2
        t_bw = bytes_ / (self.hw.host_mem_bw * self.hw.host_bw_eff)
        flops = 4.0 * kv_tokens * self.cfg.num_heads * self.cfg.head_dim
        t_fl = flops / self.hw.host_flops
        return self.scale["cpu_attn"] * (max(t_bw, t_fl) + CPU_STAGE_OVERHEAD)

    def t_swap(self, n_tokens: int) -> float:
        """PCIe transfer of `n_tokens` of one layer's KV."""
        if n_tokens <= 0:
            return 0.0
        return self.scale["swap"] * (
            n_tokens * self.kv_bytes_per_token_layer / self.hw.pcie_bw
        )

    def t_host_prefix(self, n_tokens: int) -> float:
        """Host-side DRAM gather of `n_tokens` of one layer's cached prefix
        KV (zero-copy host serving: a cpu-placed prefill whose prefix is
        host-resident reads it in place at host memory bandwidth instead of
        promoting it over PCIe — this term replaces the `t_swap` the promote
        path would pay).  Shares the host-bandwidth resource with the CPU
        attention stages, so the scheduler adds it to that side of the
        no-bubble max.  Under TP the per-shard HostAttention instances
        gather disjoint kv-head slices concurrently, so wall time divides
        by the shard count (host bytes are unchanged)."""
        if n_tokens <= 0:
            return 0.0
        bytes_ = n_tokens * self.kv_bytes_per_token_layer
        return self.scale["host_prefix"] * bytes_ / (
            self.hw.host_mem_bw * self.hw.host_bw_eff
        ) / self.tp

    def t_collective(self, n_tokens: int) -> float:
        """Per-layer cross-shard gather cost of the TP seams (seconds).

        Gather-TP concatenates two per-layer partials across shards: the
        attention head outputs ([n, H, hd]) and the MLP hidden ([n, d_ff]).
        A tiled all_gather moves ``bytes × (tp-1)/tp`` per device over the
        inter-chip links (ICI on TPU profiles; falls back to pcie_bw where
        the profile models NVLink-less GPUs).  Zero at tp == 1 — every
        single-device estimate is untouched.
        """
        if self.tp <= 1 or n_tokens <= 0:
            return 0.0
        cfg = self.cfg
        bytes_ = n_tokens * (cfg.num_heads * cfg.head_dim + cfg.d_ff) * 2
        link_bw = self.hw.ici_bw if self.hw.ici_bw > 0 else self.hw.pcie_bw
        return self.scale["collective"] * bytes_ * (self.tp - 1) / self.tp / link_bw

    def t_verify(self, k: int, *, n_rows: int, host_kv_tokens: int = 0,
                 dev_kv_tokens: int = 0) -> float:
        """Per-layer cost of a depth-``k`` speculative verify chain
        (seconds).

        Verification reuses the UNCHANGED fused decode graph: after the base
        decode emits, the engine runs up to ``k`` extra chained decode passes
        over the drafting rows (plus the pass that scores the final draft),
        so a depth-k chain prices as ``k + 1`` serial decode steps — linear
        stage over ``n_rows`` plus the rows' attention on whichever side
        their KV lives.  The composed estimators carry their own EWMA
        scales; the ``"verify"`` scale on top absorbs chain-dispatch
        overhead the per-stage models don't see (k+1 graph launches per
        step).  Zero at k == 0 — a non-speculative plan prices exactly as
        before.
        """
        if k <= 0 or n_rows <= 0:
            return 0.0
        per_pass = (self.t_linear(n_rows) + self.t_cpu_attn(host_kv_tokens)
                    + self.t_gpu_attn(dev_kv_tokens))
        return self.scale["verify"] * (k + 1) * per_pass

    def spec_expected_emitted(self, k: int) -> float:
        """Expected tokens emitted per drafting row by a depth-``k`` chain
        under the current accept-rate EWMA ``a``: the geometric sum
        ``1 + a + a² + … + a^k`` (base/bonus token plus each draft that
        survives given all earlier drafts survived).  k = 0 -> 1.0 (the
        plain decode emission)."""
        a = min(max(self.spec_accept, 0.0), 0.999)
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def observe_accept(self, drafted: int, accepted: int) -> None:
        """EWMA-refresh the speculative accept rate from one iteration's
        drafted/accepted token counts (straggler-clamped like the stage
        scales: the rate lives in [0.01, 0.99] so a cold streak cannot
        permanently disable drafting — k=0 stays available every step)."""
        if drafted <= 0:
            return
        a = self.ewma_alpha
        rate = accepted / drafted
        s = (1 - a) * self.spec_accept + a * rate
        self.spec_accept = min(max(s, 0.01), 0.99)

    def t_transfer_qo(self, n_rows: int) -> float:
        """Q down + attention-output up for offloaded rows (TrQKV/TrO)."""
        if n_rows <= 0:
            return 0.0
        bytes_ = n_rows * self.cfg.num_heads * self.cfg.head_dim * 2 * 2
        return bytes_ / self.hw.pcie_bw

    # -- iteration-level composition (the paper's T_tr formula) ------------------
    def iteration_time(
        self,
        *,
        batch0_tokens: int,
        batch1_tokens: int,
        gpu_kv_tokens: int,
        cpu0_kv_tokens: int,
        cpu1_kv_tokens: int,
        swap_tokens: int = 0,
    ) -> float:
        L = self.cfg.num_layers
        t_l0 = self.t_linear(batch0_tokens)
        t_l1 = self.t_linear(batch1_tokens)
        t_ga0 = self.t_gpu_attn(gpu_kv_tokens)
        t_ca0 = self.t_cpu_attn(cpu0_kv_tokens)
        t_ca1 = self.t_cpu_attn(cpu1_kv_tokens)
        t_sw = self.t_swap(swap_tokens)
        half1 = max(t_l0, t_ca1)
        half2 = max(t_l1 + t_ga0, t_ca0, t_sw)
        return L * (half1 + half2)

    def lane_plan_time(
        self,
        lanes: "list[tuple[int, int]]",
        *,
        device_compute: float = 0.0,
        device_host_attn: float = 0.0,
        device_collective: float = 0.0,
    ) -> float:
        """Per-layer steady-state time of a generalized lane plan: one
        optional device lane plus K host lanes (the unified form of the
        FastDecode sub-batch pipeline, §5.3 baseline lineage).

        ``lanes`` is ``[(n_tokens, kv_tokens), ...]`` — one entry per host
        lane.  ``device_compute`` is the device lane's per-layer compute
        (t_l0 + t_ga0) and ``device_host_attn`` its embedded batch-0 host
        attention (t_ca0, which blocks inside the device graph's ordered
        callback); both are 0 for batch-1-only plans.
        ``device_collective`` is the per-layer cross-shard all-gather time
        of the TP seams — it rides the device lane (the gathers sit inside
        the fused graph), so it joins both the device resource total and
        the device lane's serial chain; 0 at TP=1.

        Each host lane serializes linear → host-attention within itself;
        across lanes every linear stage shares the device and every host
        attention shares the host cores, so the steady-state per-layer
        period is bounded below by each resource's TOTAL demand and by each
        lane's own serial chain::

            max( dev + Σ T_l(i),          # device: all linear stages + lane-0
                 T_ca0 + Σ T_ca(i),       # host cores: all host attention
                 dev + T_ca0,             # the device lane's own chain
                 T_l(i) + T_ca(i) ... )   # each host lane's own chain

        All terms are EWMA-calibrated through ``t_linear``/``t_cpu_attn``,
        so the predicted overlap tracks measured lane times.  With K = 2 and
        no device lane the steady-state period reduces exactly to the PR-3
        micro-batch model.

        The steady-state period alone structurally caps the useful lane
        count at 2: splitting further shrinks per-lane stages but the
        resource TOTALS (and their dispatch overheads) only grow, so the
        argmin over K never moves past 2.  What K > 2 actually buys is a
        shorter pipeline FILL (one lane's linear must run before any host
        attention can start) and DRAIN (one lane's attention runs after the
        final layer's device work) — both shrink ~1/K.  We charge the
        AVERAGE lane's stage for each (keeping the boundary argmin for a
        fixed K identical to the pure steady-state model, since the per-K
        average is split-invariant), amortized over the iteration's L
        layers: deep splits win exactly when host attention dominates and L
        is small relative to the per-lane stage times.
        """
        t_lin = [self.t_linear(n) for n, _ in lanes]
        t_att = [self.t_cpu_attn(kv) for _, kv in lanes]
        device_total = device_compute + device_collective + sum(t_lin)
        host_total = device_host_attn + sum(t_att)
        chains = [device_compute + device_collective + device_host_attn]
        chains += [tl + ta for tl, ta in zip(t_lin, t_att)]
        period = max(device_total, host_total, *chains)
        L = max(self.cfg.num_layers, 1)
        k = max(len(lanes), 1)
        fill = sum(t_lin) / k
        drain = sum(t_att) / k
        return period + (fill + drain) / L

    def microbatch_time(self, n_a: int, kv_a: int, n_b: int, kv_b: int) -> float:
        """Two alternating batch-1 micro-batches — the K=2, no-device-lane
        degenerate case of :meth:`lane_plan_time` (kept as the historical
        entry point)."""
        return self.lane_plan_time([(n_a, kv_a), (n_b, kv_b)])

    def gpu_only_time(self, *, batch_tokens: int, gpu_kv_tokens: int,
                      prefill_sq_sum: float = 0.0) -> float:
        L = self.cfg.num_layers
        return L * (
            self.t_linear(batch_tokens)
            + self.t_prefill_attn(prefill_sq_sum)
            + self.t_gpu_attn(gpu_kv_tokens)
        )

    # -- online refresh (EWMA) = straggler mitigation -----------------------------
    # Calibration is clamped: a straggling host should shift load, not push
    # the model into a regime where offloading is never chosen again (the
    # scheduler's anti-starvation aging covers pathological stalls anyway).
    SCALE_MIN, SCALE_MAX = 0.2, 16.0

    def observe(self, stage: str, predicted: float, measured: float) -> None:
        if predicted <= 0 or measured <= 0:
            return
        ratio = measured / predicted * self.scale[stage]
        a = self.ewma_alpha
        s = (1 - a) * self.scale[stage] + a * ratio
        self.scale[stage] = min(max(s, self.SCALE_MIN), self.SCALE_MAX)

    def observe_iteration(self, stages, *, host_busy: float = 0.0,
                          device_busy: float = 0.0, swap_busy: float = 0.0,
                          host_prefix_busy: float = 0.0,
                          spec_busy: float = 0.0,
                          pipelined: bool = False) -> None:
        """Refresh calibration from one iteration's MEASURED lane times.

        ``stages`` is the chosen plan's :class:`StageEstimates` (per-layer
        T_* symbols, duck-typed to avoid a scheduler import cycle).  The
        pipelined engine passes real wall times: host attention busy time,
        the device dispatch window, and the transfer worker's copy time —
        so the no-bubble inequalities are checked against observed overlap
        rather than the model's own predictions.

        The device window is prefill + batch-0 dispatch wall time; batch-0's
        ordered host callback (t_ca0) blocks inside it, and when pipelined
        the batch-1 stages (t_l1, t_ca1) run on another lane and are NOT in
        the window — the prediction mirrors that composition so the EWMA
        "linear" scale tracks the device lane rather than a mismatched sum.

        Micro-batched batch-1-only iterations report ``device_busy == 0``
        (both lanes are host-attention graphs; their windows are tracked in
        ``EngineStats.lane_busy_time`` instead), so they refresh the
        ``cpu_attn`` scale only — exactly the stage they exercise.
        """
        L = max(self.cfg.num_layers, 1)
        if host_busy > 0:
            self.observe("cpu_attn", L * (stages.t_ca0 + stages.t_ca1), host_busy)
        if device_busy > 0:
            t_coll = getattr(stages, "t_coll", 0.0)
            pred = L * (stages.t_l0 + stages.t_ga0 + stages.t_ca0 + t_coll)
            if not pipelined:
                pred += L * (stages.t_l1 + stages.t_ca1)
            self.observe("linear", pred, device_busy)
            if t_coll > 0:
                # the all-gather rides the device dispatch window, so the
                # collective scale tracks the same measured/predicted ratio
                self.observe("collective", pred, device_busy)
        if swap_busy > 0:
            self.observe("swap", L * stages.t_swap, swap_busy)
        if host_prefix_busy > 0:
            # zero-copy host-serving gathers: HostAttention.prefix_busy_time
            # delta for this iteration vs the plan's priced t_host_prefix —
            # the last analytic-only stage joins the EWMA loop
            self.observe("host_prefix", L * stages.t_host_prefix, host_prefix_busy)
        t_verify = getattr(stages, "t_verify", 0.0)
        if spec_busy > 0 and t_verify > 0:
            # speculative verify chain: wall time of the extra chained decode
            # passes vs the plan's priced t_verify(K)
            self.observe("verify", L * t_verify, spec_busy)
