"""Chunked Mamba2 SSD recurrence: a CUDA kernel for sm_90a and its plain version."""

from repro_torch.kernels.mamba2_ssd.ops import mamba2_decode_step, mamba2_ssd  # noqa: F401
