"""Three-term roofline of a dry-run cell, the port of the JAX package's
``roofline/analysis.py`` on the H100's constants.

    compute    = counted FLOPs per chip / peak FLOP/s
    memory     = structural bytes per chip / HBM rate
    collective = ring-weighted collective bytes per chip / NVLink rate

The counter (``roofline/opcount.py``) counts one rank's work, so the
assignment's "/ chips" is already applied.  MODEL_FLOPS is 6·N·D to train
and 2·N·D to serve (N the active parameters: a MoE's routed experts at
top_k / num_experts); ``useful_flops_ratio`` (MODEL_FLOPS / global counted
FLOPs) flags recomputation and redundant work.

The constants are the H100 SXM's: ``get_profile("h100_sxm")``'s dense bf16
peak and HBM rate, and NVLink 4's 18 links of 25 GB/s per direction
(450 GB/s per card), from NVIDIA's H100 SXM data sheet.

The collective term is an NVLink-only lower bound.  NVLink joins the 8
cards of one host; across hosts a card has one 400 Gb/s InfiniBand port
(50 GB/s, NVIDIA's DGX H100), a ninth of NVLink's rate.  On the 16 x 16
and 2 x 16 x 16 meshes every axis crosses hosts (a 16-wide axis spans two
8-card hosts), so a ring collective there is bound by its InfiniBand hops
and may take up to 9x ``t_collective``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.roofline.hw import get_profile
from repro_torch.roofline.opcount import CollectiveStats

H100 = get_profile("h100_sxm")
PEAK_FLOPS = H100.device_flops  # 989e12 dense bf16
HBM_BW = H100.device_hbm_bw  # 3.35e12
NVLINK_BW = 25e9  # per link and direction (NVIDIA H100 SXM data sheet)
NVLINK_LINKS = 18  # NVLink 4: 18 x 25 GB/s = 450 GB/s per direction per card


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D (training) / 2·N·D (inference forward); a decode shape
    processes ONE token per sequence (D = global_batch)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-chip quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_weighted: float
    collectives: Dict[str, Any] = field(default_factory=dict)
    memory_per_chip_bytes: float = 0.0
    model_flops_global: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        """At NVLink's rate: a lower bound (module docstring)."""
        return self.collective_bytes_weighted / (NVLINK_LINKS * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total_hlo = self.hlo_flops * self.chips
        if total_hlo <= 0:
            return 0.0
        return self.model_flops_global / total_hlo

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak that the dominant-term-limited step
        achieves on USEFUL model flops: (model_flops/chips/peak) / t_bound."""
        if self.t_bound <= 0:
            return 0.0
        return self.mfu(self.t_bound)

    def mfu(self, t_step: float) -> float:
        """The model-FLOP share of a step that took ``t_step`` seconds:
        model_flops / chips / peak / t_step."""
        return self.model_flops_global / self.chips / PEAK_FLOPS / t_step

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_weighted_per_chip": self.collective_bytes_weighted,
            "collectives": self.collectives,
            "memory_per_chip_GB": round(self.memory_per_chip_bytes / 1e9, 3),
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": round(self.useful_flops_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
        }


def build_report(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh_name: str,
    chips: int,
    *,
    flops_per_chip: float,
    bytes_per_chip: float,
    collectives: CollectiveStats,
    memory_per_chip: float = 0.0,
) -> RooflineReport:
    return RooflineReport(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=flops_per_chip,
        hlo_bytes=bytes_per_chip,
        collective_bytes_weighted=float(collectives.weighted_bytes()),
        collectives=collectives.summary(),
        memory_per_chip_bytes=memory_per_chip,
        model_flops_global=model_flops(cfg, shape),
    )
