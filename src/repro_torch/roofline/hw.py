"""Hardware profiles.

``tpu_v5e`` is the JAX package's profile, kept here unchanged for parity
with its serving simulator and perf model; no number of the port is taken
on or for it.  The port's roofline (``roofline/analysis.py``) reads
``h100_sxm``.  The GPU profiles reproduce the paper's testbeds (Table 1)
for the paper-figure benchmarks; the host-side numbers follow the paper's
§2.2 (A10G hosts ≈ EPYC 7R32 with ~100–400 GB/s depending on the g5
instance size, §5.5).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    # accelerator ("device") side
    device_flops: float  # peak FLOP/s (bf16/fp16 tensor)
    device_hbm_bw: float  # bytes/s
    device_hbm_bytes: float  # raw HBM bytes (pool sizing subtracts weights + headroom)
    # host ("CPU") side
    host_mem_bw: float  # bytes/s usable for the attention kernel
    host_flops: float  # peak host FLOP/s (vectorised)
    host_mem_bytes: float  # host DRAM usable for the KV pool
    # interconnects
    pcie_bw: float  # bytes/s effective device<->host
    ici_bw: float = 0.0  # bytes/s per link (TPU only)
    num_ici_links: int = 0
    # empirical efficiency factors (fractions of peak actually achieved by
    # the respective stage; calibrated in perfmodel tests)
    linear_eff: float = 0.55
    attn_bw_eff: float = 0.7
    host_bw_eff: float = 0.65


_P = HardwareProfile

HARDWARE: Dict[str, HardwareProfile] = {
    # --- the JAX package's profile (parity with its simulator) ----------------
    "tpu_v5e": _P(
        name="tpu_v5e",
        device_flops=197e12,
        device_hbm_bw=819e9,
        device_hbm_bytes=16e9,
        host_mem_bw=200e9,  # per-host DRAM bw (one NUMA node of a v5e host)
        host_flops=2e12,
        host_mem_bytes=192e9,
        pcie_bw=32e9,
        ici_bw=50e9,
        num_ici_links=4,
    ),
    # --- the paper's testbeds (Table 1) -----------------------------------------
    "t4_g4dn": _P(
        name="t4_g4dn",
        device_flops=65e12,
        device_hbm_bw=320e9,
        device_hbm_bytes=16e9,
        host_mem_bw=40e9,  # 8-core Xeon P-8259CL slice
        host_flops=0.6e12,
        host_mem_bytes=64e9,
        pcie_bw=12e9,
    ),
    "a10g_g5_4x": _P(
        name="a10g_g5_4x",
        device_flops=125e12,
        device_hbm_bw=600e9,
        device_hbm_bytes=24e9,
        host_mem_bw=50e9,  # EPYC 7R32, 8 cores (g5.4xlarge slice)
        host_flops=1.2e12,
        host_mem_bytes=64e9,
        pcie_bw=16e9,
    ),
    "h100_sxm": _P(
        name="h100_sxm",
        device_flops=989e12,
        device_hbm_bw=3350e9,
        device_hbm_bytes=80e9,
        host_mem_bw=100e9,  # one NUMA node of Xeon 8462Y+
        host_flops=2e12,
        host_mem_bytes=512e9,
        pcie_bw=32e9,
    ),
}

# g5 instance family for the Fig. 10a host-bandwidth sensitivity study
for _n, _bw, _mem in [("2x", 48e9, 32e9), ("4x", 50e9, 64e9), ("8x", 100e9, 128e9), ("16x", 200e9, 256e9)]:
    HARDWARE[f"a10g_g5_{_n}"] = replace(
        HARDWARE["a10g_g5_4x"], name=f"a10g_g5_{_n}", host_mem_bw=_bw, host_mem_bytes=_mem
    )


def get_profile(name: str) -> HardwareProfile:
    try:
        return HARDWARE[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; have {sorted(HARDWARE)}") from None
