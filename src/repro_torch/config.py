"""Configuration of the PyTorch port of the NEO engine.

Every architecture is described by an :class:`ArchConfig`, the serving
runtime by an :class:`EngineConfig`, a training run by a
:class:`TrainConfig` and a dry-run cell's input shape by a
:class:`ShapeConfig`.  All are plain frozen dataclasses so
they hash, compare and print deterministically; architectures are registered
by name in :mod:`repro_torch.configs` (``--arch <id>`` on every CLI).  The
field set and defaults mirror the JAX package's config so both sides describe
one model, except ``EngineConfig.hw_profile``, which defaults to the H100.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (DeepSeek-MoE / Llama-4 style)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    # Apply MoE every `interleave` layers (1 = every layer, 2 = alternating).
    interleave: int = 1
    # Layers < first_dense_layers use a dense FFN of width `first_dense_d_ff`.
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    # Token-dropping capacity factor for the scatter/dense dispatch paths.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    dispatch: str = "scatter"  # "scatter" | "dense"

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_dense_layers:
            return False
        return (layer_idx - self.first_dense_layers) % self.interleave == 0


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence configuration (RWKV6, Mamba2)."""

    kind: str  # "rwkv6" | "mamba2"
    state_dim: int = 64  # per-head recurrent state size
    head_dim: int = 64
    expand: int = 2  # mamba2 inner expansion
    conv_kernel: int = 4  # mamba2 depthwise conv width
    chunk_size: int = 64  # chunked-scan block length (train/prefill)


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder–decoder configuration (Seamless-M4T backbone)."""

    encoder_layers: int
    # Encoder memory length used by decode-shape dry-runs (frames after the
    # stubbed audio frontend).
    encoder_memory_len: int = 4096


@dataclass(frozen=True)
class ModalityStub:
    """Stubbed modality frontend: ``input_specs()`` provides precomputed
    frame/patch embeddings, as the assignment requires."""

    kind: str  # "vision" | "audio"
    num_embeds: int  # patches per image / frames per utterance
    embed_dim: int  # dimension of the precomputed embeddings


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Attention details.
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    attn_logit_softcap: float = 0.0
    # Sliding window applied in long-context (``long_*``) shapes only; 0 = full.
    long_context_window: int = 0

    # Family-specific blocks.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    modality: Optional[ModalityStub] = None

    # Hybrid (zamba2): a shared full-attention transformer block is applied
    # every `shared_attn_every` SSM blocks (0 = never).
    shared_attn_every: int = 0

    # Norm / misc.
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- NEO / serving attributes -------------------------------------------------
    # Whether the arch has a growing KV cache that NEO offloading applies to.
    supports_offload: bool = True
    kv_block_size: int = 16  # paged-KV page length (tokens)

    # --- dtype policy ---------------------------------------------------------
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # Serve-path KV cache storage: "" = activation dtype; "int8" halves the
    # decode memory-roofline term (per-token-per-head scales kept in f32).
    kv_cache_dtype: str = ""

    # --- sharding policy ------------------------------------------------------
    # How the decode KV cache shards over the "model" mesh axis:
    #  "heads"  — kv-head dim sharded (requires kv_heads % model_axis == 0)
    #  "blocks" — KV pages sharded; decode attention runs split-K via shard_map
    #  "replicated" — tiny models: KV replicated over model axis
    kv_shard_mode: str = "heads"
    # Extra logical-axis -> mesh-axis rules for this arch (e.g. 400B MoE
    # shards expert_ff over "data" so weights fit 16 GB/chip).
    sharding_overrides: Tuple[Tuple[str, str], ...] = ()
    # Per-chip microbatch tokens for train cells (0 = auto heuristic).
    train_micro_tokens: int = 0
    # Megatron-style sequence parallelism on the residual stream during
    # training (seq -> "model"); recurrent scans (ssm) keep it off.
    seq_parallel_train: bool = True
    # Optimizer-state policy for the train path of this size class:
    #  "zero" — fp32 m/v sharded over (data, model); "lite" — bf16 m + factored v.
    opt_state_policy: str = "zero"
    remat_policy: str = "none"  # none | minimal | full

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads ({self.num_heads}) must be a multiple "
                f"of num_kv_heads ({self.num_kv_heads})"
            )
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: family=moe requires a MoEConfig")
        if self.family in ("ssm",) and self.ssm is None:
            raise ValueError(f"{self.name}: family=ssm requires an SSMConfig")

    # -- convenience -----------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_encoder(self) -> bool:
        return self.encdec is not None

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Bytes of KV cache one token occupies across all layers."""
        if self.is_attention_free:
            return 0
        n_attn_layers = self.num_attention_layers
        return 2 * n_attn_layers * self.num_kv_heads * self.head_dim * dtype_bytes

    @property
    def num_attention_layers(self) -> int:
        if self.family == "hybrid" and self.shared_attn_every:
            return self.num_layers // self.shared_attn_every
        if self.has_encoder:
            return self.num_layers  # decoder self-attn layers
        return self.num_layers

    def replace(self, **kw: Any) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (used by roofline MODEL_FLOPS and perf model) --
    def param_count(self) -> int:
        from repro_torch.models.api import param_count  # local import to avoid cycle

        return param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.api import active_param_count

        return active_param_count(self)


# ---------------------------------------------------------------------------
# Shape config (the dry run's input-shape cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    @property
    def is_long_context(self) -> bool:
        return self.seq_len >= 262_144


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME: Mapping[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def shapes_for_arch(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The shape set of one architecture: ``long_500k`` needs sub-quadratic
    attention, so only the ssm and hybrid families (rwkv6, zamba2) take it."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append(LONG_500K)
    return tuple(shapes)


# ---------------------------------------------------------------------------
# Engine / serving runtime config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineConfig:
    """Runtime configuration of the NEO serving engine."""

    # KV pool sizes, in pages (block_size tokens per page).
    device_pool_pages: int = 512
    host_pool_pages: int = 2048
    max_batch_tokens: int = 8192  # activation budget per iteration (batch-0)
    max_requests: int = 256
    # Scheduling mode: "neo" (asymmetric pipelining + load-aware scheduling),
    # "gpu_only" (no offloading — the paper's baseline / SwiftLLM),
    # "fastdecode" (offload ALL decode attention — the FastDecode+ baseline),
    # "simple" (strawman #1: offload w/o overlap).
    policy: str = "neo"
    # Pipelined plan→launch→join execution (async TransferEngine swaps +
    # batch-1 host attention overlapped with batch-0's device dispatch).
    # Default for paged families; False forces the serial reference path.
    # "serial"-mode plans (policy="simple") always execute serially.
    pipeline: bool = True
    # Multi-lane host attention (unified lane plans): when a plan's batch-1
    # host rows have no LONG device lane to hide under — either no batch-0 at
    # all (FastDecode-style batch-1-only plans) or a decode-only batch-0 with
    # no prefill (a SHORT device lane) — split them into K alternating host
    # lanes so one lane's host attention overlaps the other lanes' linear
    # stages (and the device lane, when present).  Eligibility is structural;
    # the perf model picks K and the per-lane row split by minimizing
    # ``PerfModel.lane_plan_time``.  Only acts when ``pipeline`` is on; False
    # falls back to the single-lane (K=1) batch-1 path.
    microbatch: bool = True
    # Upper bound on K, the number of concurrent host lanes a plan may split
    # batch-1 into (>= 2 to allow any split; the executor keeps one dispatch
    # thread per lane).  2 reproduces the PR-3 two-lane micro-batch exactly.
    max_host_lanes: int = 4
    # Two-tier radix prefix cache (core/prefix_cache.py): finished requests'
    # KV pages are kept in a radix tree spanning both pools and shared
    # copy-on-write with later requests that repeat the prefix.  Off by
    # default — the compat path is bitwise identical to the uncached engine.
    prefix_cache: bool = False
    # Token-granular radix matching/insertion: leaves keep a partial tail
    # page beyond their last full page and matches land at any token offset
    # (served copy-on-write).  False restores the PR-2 page-aligned radix
    # (full pages only, exact first-page keys) for A/B measurement.
    prefix_token_granular: bool = True
    # Zero-copy host-tier serving: prefills whose longest cached prefix is
    # host-resident are preferentially placed on the CPU queue so acquire()
    # pins the prefix IN PLACE (no promotion PCIe) and host attention serves
    # it from DRAM.  False keeps the PR-2 placement (device first).
    prefix_host_serving: bool = True
    # Plan-ahead scheduling: a planner thread builds iteration N+1's lane
    # plan against the PREDICTED post-step queue/pool view while iteration
    # N's lanes execute, so the plan phase leaves the critical path.  The
    # speculative plan is validated against the real state at the next step
    # and cheaply replanned when an arrival, departure, or preemption
    # falsified it (EngineStats.planahead_hits / planahead_replans).  Only
    # acts with ``pipeline`` on and the paged executor; greedy outputs are
    # bitwise identical either way (plans may differ, outputs may not).
    planahead: bool = True
    # Admission control for the open-loop serving front end: reject new
    # arrivals (NeoEngine.offer returns None) while the waitqueue holds this
    # many requests.  0 = unbounded (the closed-loop behavior).
    max_waiting: int = 0
    # Perf-model refresh rate (EWMA) — also the straggler-mitigation knob.
    ewma_alpha: float = 0.2
    # Force a host request into batch-1 after this many consecutive skips
    # (anti-starvation override of the no-bubble inequalities).
    starvation_limit: int = 8
    # Structured engine tracing: when on, a monotonic-clock
    # span tracer records the plan -> launch -> join timeline (per-lane
    # dispatch windows, copy streams, planner thread, request lifecycles)
    # for Perfetto export and stats reconciliation.  Off by default; every
    # call site guards on the tracer, so greedy outputs are bitwise
    # identical tracing on vs off.
    tracing: bool = False
    # Tracer ring-buffer capacity in events.  When full the OLDEST events
    # are overwritten (counted in SpanTracer.dropped) — emission never
    # blocks the engine thread.
    trace_buffer: int = 65536
    # Hardware profile name from roofline/hw.py used by the perf model.
    hw_profile: str = "h100_sxm"
    host_threads: int = 1
    decode_sample: str = "greedy"  # greedy | temperature
    # Tensor-parallel shard count (gather-TP over the mesh "model" axis).
    # tp=1 is the single-device engine, byte-for-byte; tp>1 shards the fused
    # decode/prefill graphs, the device KV pool, the host-attention KV heads
    # and the copy streams while the scheduler stays device-count-agnostic.
    tp: int = 1
    # Speculative decoding (SpecOffload-style): decode-only iterations draft
    # up to ``spec_k`` tokens per row (n-gram prompt lookup by default) and
    # verify them with chained passes of the SAME fused decode graph, so
    # greedy outputs stay bitwise identical to non-speculative decode BY
    # CONSTRUCTION (verification recomputes the exact serial logits; a
    # rejection truncates the row — out_tokens AND speculative KV pages —
    # back to them).  Eligibility is structural (decode-only plans, greedy
    # sampling); the perf model prices the chain depth K per step via
    # PerfModel.t_verify, mirroring how lane counts are chosen.
    spec_decode: bool = False
    # Maximum draft length per row per step (the scheduler picks the
    # realized K in [0, spec_k] each iteration from the accept-rate EWMA).
    spec_k: int = 4
    # N-gram order for the prompt-lookup drafter: the trailing spec_ngram
    # tokens are matched against the request's earlier tokens and the
    # continuation of the most recent match is proposed.
    spec_ngram: int = 3
    seed: int = 0


# ---------------------------------------------------------------------------
# Training config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """A data x model device mesh, with a leading ``pod`` axis when
    ``pods > 1``: the JAX package's ``MeshConfig``."""

    data: int = 16
    model: int = 16
    pods: int = 1  # >1 adds the leading "pod" axis

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pods

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 else (self.data, self.model)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    grad_accum: int = 1
    # Gradient compression for the DP all-reduce: "none" | "int8".
    grad_compression: str = "none"
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
